"""``scripts/fused_rmsf_trace.py`` on the CPU: its stamps find their
lines in the fused kernel's source, and its wide-mode summary reads a
timeline back.

The script inserts timestamps after fixed lines of
``csrc/fused_rmsf.cu`` and stops on the card when a line is gone; these
tests catch that here, when the kernel is edited.  The summary is held
to a synthetic timeline of known periods, waits and work, stamped in SM
clocks as the kernel stamps them.
"""

import importlib.util
import os

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "mdanalysis_mpi_tpu_torch", "csrc",
                      "fused_rmsf.cu")


@pytest.fixture(scope="module")
def trace():
    spec = importlib.util.spec_from_file_location(
        "fused_rmsf_trace", os.path.join(ROOT, "scripts",
                                         "fused_rmsf_trace.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_stamps_find_their_lines_in_the_kernel(trace):
    with open(SOURCE) as f:
        src = f.read()
    assert trace.wide_layout(src) == "boxes"
    traced = trace.traced_source(src)
    # every stamp of the layout once, the macros' definitions once more
    points = trace.WIDE_POINTS["boxes"]
    for macro in ("TRACE_W(", "TRACE_CAL("):
        stamps = sum((macro in before) + (macro in after)
                     for _, before, after in points)
        assert stamps > 0 and traced.count(macro) == stamps + 1
    assert "mdtpu_fused_set_trace" in traced


def test_a_source_without_a_line_stops_the_script(trace):
    with open(SOURCE) as f:
        src = f.read()
    broken = src.replace("        if (c == 0) {\n          const int need",
                         "        if (c == 0) {\n          int need")
    assert broken != src
    with pytest.raises(RuntimeError, match="update the trace points"):
        trace.wide_layout(broken)


@pytest.mark.parametrize("itemsize", [1, 2, 4])
def test_wide_summary_reads_a_synthetic_timeline_back(trace, itemsize):
    """Every block runs its units back to back: pass A at a 2 µs period
    (0.5 µs waiting on data, 1.2 µs of work), pass B at 3 µs (0.4 data,
    0.3 records on the first chunk, 2 work), 5 µs more before pass B's
    first unit (a turn of 6 µs to its records), the loader
    issuing each unit 4 µs before its turn in 0.25 µs; SM clocks at
    1.8 GHz from a per-block start."""
    B, S = 64, fp.fused_max_atoms(itemsize, 132) + 256
    geometry = fp.fused_geometry(B, S, itemsize, 132)
    slice_atoms, blocks = geometry[:2]
    stride = trace.wide_stride("boxes", B, geometry)
    W = np.zeros((blocks, stride, 8), np.int64)
    cal = np.zeros((blocks, 2, 2), np.int64)
    T = np.zeros((blocks, -(-B // geometry[2]), 8), np.int64)
    ghz = 1.8
    for b in range(blocks):
        owned = min(slice_atoms, S - b * slice_atoms)
        na, nb, first = trace.WIDE_UNITS["boxes"](B, owned, geometry)
        clk0 = 1000 * (b + 1)
        t = 0.0                                        # µs from start
        rows = []
        for u in range(na + nb):
            a = u < na
            turn = t
            data = turn + (0.5 if a else 0.4)
            rec = data + 0.3 if (not a and u - na < first) else None
            done = (rec or data) + (1.2 if a else 2.0)
            rows.append((turn, data, rec, done))
            t = turn + (2.0 if a else 3.0) + (5.0 if u == na - 1 else 0)
        for u, (turn, data, rec, done) in enumerate(rows):
            stamp = {0: turn, 1: data, 3: done, 4: turn - 4.25,
                     5: turn - 4.0}
            if rec is not None:
                stamp[2] = rec
            for k, v in stamp.items():
                W[b, u, k] = clk0 + round((v + 10.0) * 1e3 * ghz)
        cal[b, 0] = (10**9, clk0)
        cal[b, 1] = (10**9 + 10**6, clk0 + round(10**6 * ghz))
    T[:, :, 5] = 10**9 + 5000
    row = trace.summarize_wide(W, cal, T, "boxes", B, S, geometry,
                               itemsize)
    expect = {"a_period": 2.0, "a_data": 0.5, "a_work": 1.2,
              "b_data": 0.4, "b_records": 0.3, "b_work": 2.0,
              "b_period": 3.0, "a_lead": 4.0, "a_empty": 0.25,
              "turn": 6.0}
    for key, value in expect.items():
        assert row[key] == pytest.approx(value, abs=2e-3), key
    assert row["clock"] == pytest.approx(ghz, rel=1e-6)
    nbytes = 3 * geometry[2] * geometry[4] * itemsize
    assert row["a_rate"] == pytest.approx(blocks * nbytes / 2.0 * 1e-6,
                                          rel=1e-3)
