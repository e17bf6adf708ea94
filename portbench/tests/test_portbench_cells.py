"""Every cell, at a tiny size on the CPU, against the plain reference."""

import pytest

from portbench.tests._tiny import TINY, listed, run_cpu


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_is_correct_at_a_tiny_size(cell):
    rc, result, err = run_cpu(cell, TINY[cell])
    assert rc == 0, err[-3000:]
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) >= {"setup_s"}
    assert result["device"]["count"] == (4 if "4rank" in cell else 1)


@pytest.mark.parametrize("cell", ["rmsf_heavy_100k.memory",
                                  "rdf_oo_32k.memory"])
def test_traced_run_reports_the_per_layer_metrics(cell):
    rc, result, err = run_cpu(cell, TINY[cell], trace=1)
    assert rc == 0, err[-3000:]
    kind = "rmsf" if "rmsf" in cell else "rdf"
    # no card: every metric the cell lists but the device roofline, the
    # whole window idle
    assert set(result["metrics"]) == (listed(cell)
                                      - {f"device_roofline.{kind}"})
    assert result["metrics"][f"device_idle.{kind}"]["value"] == 100.0
    assert result["device"]["window_s"] > 0
    assert "device_ops" in result["breakdown"]


def test_no_card_refuses_and_prints_no_result():
    import subprocess
    import sys

    from portbench.tests._tiny import ROOT

    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "rmsf_heavy_100k.memory", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
