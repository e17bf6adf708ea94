"""The program's phases read as per-layer metrics: in a traced run on
the CPU every metric ``BENCHMARK.json`` lists for the cell is in the
line, but the device roofline (no card, no kernel time), and each phase
share lies within the window."""

import pytest

from portbench.tests._tiny import TINY, listed, run_cpu

#: the shares of the program's phases, by the cells that list them
PHASE_SHARES = {
    "rmsf_heavy_100k.memory": ["stage_wait_share.rmsf", "gather_share.rmsf",
                               "wire_share.rmsf", "pass1_share.rmsf"],
    "rmsf_heavy_100k.store": ["stage_wait_share.rmsf", "gather_share.rmsf",
                              "repack_share.rmsf", "chunk_read_share.rmsf",
                              "wire_share.rmsf", "pass1_share.rmsf"],
    "rdf_oo_32k.memory": ["stage_wait_share.rdf"],
}


@pytest.mark.parametrize("cell", sorted(PHASE_SHARES))
def test_traced_run_reads_the_staging_phases(cell):
    rc, result, err = run_cpu(cell, TINY[cell], trace=1)
    assert rc == 0, err[-3000:]
    kind = "rmsf" if "rmsf" in cell else "rdf"
    mine = listed(cell)
    assert set(PHASE_SHARES[cell]) <= mine
    assert set(result["metrics"]) == mine - {f"device_roofline.{kind}"}
    for name in PHASE_SHARES[cell]:
        m = result["metrics"][name]
        assert m["unit"] == "%" and 0 < m["value"] <= 100, (name, m)
    if kind == "rmsf":
        shares = {k: v["value"] for k, v in result["metrics"].items()}
        # the leaves nest inside the stage timer
        leaves = sum(shares[k] for k in ("gather_share.rmsf",
                                         "repack_share.rmsf") if k in mine)
        assert leaves <= shares["stage_share.rmsf"]
