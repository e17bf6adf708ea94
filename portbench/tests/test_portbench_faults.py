"""The comparison fails what it must fail: the control (the answers one
precision below the configuration's), and a run whose timed path is
broken underneath: a step that leaves its state unchanged, half of each
block left out with the mean taken over the rest, an answer altered
where it is produced, and the exchange between ranks left out.  Each
fault is planted in the program by a ``sitecustomize`` module, so it
reaches every process of a run."""

import numpy as np
import pytest

from portbench import harness
from portbench.analyses import inter_rdf
from portbench.frames import Frames
from portbench.tests._tiny import RESIDENT, TINY, plant, run_cpu, with_config

RMSF_FAULTS = {
    "unchanged": """
        import torch
        import mdanalysis_mpi_tpu_torch.ops.fused_planar as fp

        def planar_sums(qp, inv, wN, refc_p, amask, sref, fmask):
            return torch.zeros((6, qp.shape[2]), dtype=torch.float32)

        fp.planar_sums = planar_sums
    """,
    "half_batch": """
        import mdanalysis_mpi_tpu_torch.ops.fused_planar as fp

        _core = fp._core_planar

        def _core_planar(qp, inv, wN, refc_p, amask, sref, fmask):
            kept = fmask.clone()
            kept[len(kept) // 2:] = 0
            return _core(qp, inv, wN, refc_p, amask, sref, kept)

        fp._core_planar = _core_planar
    """,
    "altered": """
        import mdanalysis_mpi_tpu_torch.ops.fused_planar as fp

        _sums = fp.planar_sums

        def planar_sums(*args):
            out = _sums(*args)
            out[3, 0] *= 4.0
            return out

        fp.planar_sums = planar_sums
    """,
}
RDF_FAULTS = {
    "unchanged": """
        import torch
        import mdanalysis_mpi_tpu_torch.ops.fused_distances as fd

        _batch = fd.pair_histogram_batch

        def pair_histogram_batch(a, b, boxes, mask, edges, **kw):
            counts, vol, t = _batch(a, b, boxes, mask, edges, **kw)
            return torch.zeros_like(counts), vol, t

        fd.pair_histogram_batch = pair_histogram_batch
    """,
    "half_batch": """
        import mdanalysis_mpi_tpu_torch.analysis.rdf as rdf

        _kernel_for = rdf._rdf_kernel

        def _rdf_kernel(*args):
            inner = _kernel_for(*args)

            def kernel(params, batch, boxes, mask):
                kept = mask.clone()
                kept[len(kept) // 2:] = 0
                return inner(params, batch, boxes, kept)

            return kernel

        rdf._rdf_kernel = _rdf_kernel
    """,
    "altered": """
        import mdanalysis_mpi_tpu_torch.ops.fused_distances as fd

        _batch = fd.pair_histogram_batch

        def pair_histogram_batch(a, b, boxes, mask, edges, **kw):
            counts, vol, t = _batch(a, b, boxes, mask, edges, **kw)
            counts[len(counts) // 2] *= 2
            return counts, vol, t

        fd.pair_histogram_batch = pair_histogram_batch
    """,
}
EXCHANGE = """
    import torch
    import mdanalysis_mpi_tpu_torch.parallel.distributed as d

    d.Collectives.all_reduce = lambda self, t: torch.as_tensor(t)
"""

CASES = ([("rmsf_heavy_100k.memory", f) for f in RMSF_FAULTS]
         + [("rmsf_heavy_100k.store", f) for f in RMSF_FAULTS]
         + [("rdf_oo_32k.memory", f) for f in RDF_FAULTS]
         + [("rmsf_heavy_100k_4rank.memory", f)
            for f in list(RMSF_FAULTS) + ["exchange"]])


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(tmp_path, cell, fault):
    table = RDF_FAULTS if "rdf" in cell else dict(RMSF_FAULTS,
                                                  exchange=EXCHANGE)
    rc, result, err = run_cpu(cell, TINY[cell], env=plant(tmp_path,
                                                           table[fault]))
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]
    assert result["failed"] == result["attempted"]


@pytest.mark.parametrize("cell", ["rmsf_heavy_100k.memory",
                                  "rmsf_heavy_100k.store"])
def test_rmsf_control_int8_is_not_correct(cell):
    rc, result, err = run_cpu(cell, with_config(TINY[cell],
                                                transfer_dtype="int8"))
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("fault", sorted(RMSF_FAULTS))
def test_a_broken_resident_path_is_not_correct(tmp_path, fault):
    cell, sizes = RESIDENT
    rc, result, err = run_cpu(cell, sizes, env=plant(tmp_path,
                                                     RMSF_FAULTS[fault]))
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]
    assert result["failed"] == result["attempted"]


def test_resident_control_int8_is_not_correct():
    cell, sizes = RESIDENT
    rc, result, err = run_cpu(cell, with_config(sizes, transfer_dtype="int8"))
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]


def test_rdf_control_bfloat16_is_not_correct():
    cell = harness.load_cell("rdf_oo_32k.memory", TINY["rdf_oo_32k.memory"])
    frames = Frames(cell.cfg, 77, cell.n_frames, "cpu")
    ref = inter_rdf.reference(cell.cfg, frames)
    got = inter_rdf.compare([inter_rdf.control(cell.cfg, frames)], ref)
    limits = cell.cfg["limits"]
    assert any(got[k] > limits[k] for k in limits), got
    assert np.isfinite(list(got.values())).all()
