"""The XTC cell, ``rmsf_heavy_100k.xtc``, at a tiny size on the CPU: its
answers against the plain reference, its traced line, the file's
directory gone after the run, a file written too coarse failing the
comparison, and the set-up's writer against one ``write_xtc`` call."""

import os

import numpy as np

from portbench.tests._tiny import listed, run_cpu, with_config

CELL = "rmsf_heavy_100k.xtc"
#: the memory cell's tiny size (``_tiny.RMSF``)
TINY = {"config": {"n_atoms": 1024, "n_frames": 2048, "batch_size": 256,
                   "warmup_frames": 256}}


def _left(tmp_path):
    return [p for p in os.listdir(tmp_path) if p.startswith("portbench_")]


def test_cell_is_correct_and_removes_its_file(tmp_path):
    rc, result, err = run_cpu(CELL, TINY, env={"TMPDIR": str(tmp_path)})
    assert rc == 0, err[-3000:]
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"rmsf_frames_per_s", "setup_s"}
    assert result["device"]["count"] == 1
    assert _left(tmp_path) == []


def test_traced_line_reads_the_decode(tmp_path):
    """Every metric the cell lists but the device roofline (no card);
    ``decode`` lies inside ``gather``, which lies inside ``stage``."""
    rc, result, err = run_cpu(CELL, TINY, trace=1,
                              env={"TMPDIR": str(tmp_path)})
    assert rc == 0, err[-3000:]
    assert "decode_share.rmsf" in listed(CELL)
    assert set(result["metrics"]) == listed(CELL) - {"device_roofline.rmsf"}
    share = {k: v["value"] for k, v in result["metrics"].items()}
    assert 0 < share["decode_share.rmsf"] <= share["gather_share.rmsf"]
    assert (share["gather_share.rmsf"] + share["repack_share.rmsf"]
            <= share["stage_share.rmsf"])
    assert _left(tmp_path) == []


def test_a_file_written_at_1_A_is_not_correct(tmp_path):
    """Precision 10 (0.1 nm = 1 Å) in place of the configuration's
    1000: the file's rounding swamps the limits."""
    rc, result, err = run_cpu(CELL, with_config(TINY, xtc_precision=10),
                              env={"TMPDIR": str(tmp_path)})
    assert rc == 0, err[-3000:]
    assert not result["correct"], result["checks"]
    assert result["failed"] == result["attempted"]


def test_the_parts_join_into_one_write_xtc(tmp_path, monkeypatch):
    from mdanalysis_mpi_tpu_torch.io.xtc import write_xtc
    from portbench.sources import xtc

    monkeypatch.setattr(xtc, "PART_FRAMES", 7)
    frames = np.random.default_rng(3).normal(
        scale=10.0, size=(30, 40, 3)).astype(np.float32)
    for dims in (None, np.array([60.0, 60, 60, 90, 90, 90], np.float32)):
        xtc.write(str(tmp_path / "parts.xtc"), frames, dims, 1000)
        write_xtc(str(tmp_path / "one.xtc"), frames, dimensions=dims,
                  precision=1000)
        with open(tmp_path / "parts.xtc", "rb") as a, \
                open(tmp_path / "one.xtc", "rb") as b:
            assert a.read() == b.read()
    assert sorted(os.listdir(tmp_path)) == ["one.xtc", "parts.xtc"]
