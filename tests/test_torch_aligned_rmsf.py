"""The port's main path, ``AlignedRMSF`` (average structure, then RMSF
after superposition onto it), on ``device="cpu"`` against the JAX
package's ``backend="jax"`` run and the serial float64 oracle.

Both packages build the same universe from the same seed (the port's
``testing`` module is a copy of the JAX package's).  56 frames at batch
16 leave an uneven last block; the 16-atom ``name CA`` selection pads
to 256 atoms on the fused path.  Tolerances are those of
tests/test_pallas_fused.py: fused against generic on the same wire
format within 5e-4 (5e-3 for delta), and against the oracle within
1e-3 (5e-2 for the coarse int8 and delta formats).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

# small shapes: one intra-op thread, so these tests leave the CPU to the
# other test workers' timing-sensitive tests
torch.set_num_threads(1)

from mdanalysis_mpi_tpu.analysis import AlignedRMSF as JAlignedRMSF  # noqa: E402
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_protein_universe as jax_make_protein_universe)

from mdanalysis_mpi_tpu_torch.analysis import (AlignedRMSF,  # noqa: E402
                                               AverageStructure, RMSF)
from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp  # noqa: E402
from mdanalysis_mpi_tpu_torch.parallel.executors import (  # noqa: E402
    DeviceBlockCache, TorchExecutor, get_executor)
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe  # noqa: E402

SEL = "name CA"
FIXTURE = dict(n_residues=16, n_frames=56, noise=0.2)


@pytest.fixture(scope="module")
def u56():
    return make_protein_universe(**FIXTURE)


@pytest.fixture(scope="module")
def ju56():
    return jax_make_protein_universe(**FIXTURE)


@pytest.fixture(scope="module")
def oracle56(u56):
    return AlignedRMSF(u56, select=SEL).run(backend="serial").results.rmsf


def test_fixtures_and_oracles_agree(u56, ju56, oracle56):
    np.testing.assert_array_equal(u56.trajectory.read_block(0, 56)[0],
                                  ju56.trajectory.read_block(0, 56)[0])
    j = JAlignedRMSF(ju56, select=SEL).run(backend="serial").results.rmsf
    np.testing.assert_allclose(oracle56, j, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "int16", "int8", "delta"])
@pytest.mark.parametrize("engine", [None, "fused"])
def test_aligned_rmsf_matches_jax_and_oracle(u56, ju56, oracle56, dtype,
                                             engine):
    run = dict(batch_size=16, transfer_dtype=dtype)
    port = AlignedRMSF(u56, select=SEL, engine=engine).run(
        backend="torch", device="cpu", **run)
    ref = JAlignedRMSF(ju56, select=SEL, engine=engine).run(
        backend="jax", **run)
    raw = port.results["rmsf"]
    assert isinstance(raw, torch.Tensor) and raw.device.type == "cpu"
    rmsf = port.results.rmsf
    assert isinstance(rmsf, np.ndarray) and rmsf.shape == (16,)
    tol = 5e-3 if dtype == "delta" else 5e-4
    np.testing.assert_allclose(rmsf, np.asarray(ref.results.rmsf), atol=tol)
    atol = 5e-2 if dtype in ("int8", "delta") else 1e-3
    np.testing.assert_allclose(rmsf, oracle56, atol=atol)


@pytest.mark.parametrize("dtype", ["int16", "int8", "delta"])
def test_fused_matches_generic_same_wire(u56, dtype):
    """Fused against the generic form on the same staged bytes: only
    the kernel's algebra differs (QCP in the sweep vs SVD Kabsch)."""
    run = dict(backend="torch", device="cpu", batch_size=16,
               transfer_dtype=dtype)
    fused = AlignedRMSF(u56, select=SEL, engine="fused").run(**run)
    generic = AlignedRMSF(u56, select=SEL).run(**run)
    np.testing.assert_allclose(fused.results.rmsf, generic.results.rmsf,
                               atol=5e-3 if dtype == "delta" else 5e-4)


def test_fused_matches_jax_pallas_interpret(u56, ju56, monkeypatch):
    """The JAX run with its Pallas kernel on (interpret mode on the
    CPU) against the port's fused run on the same wire format."""
    monkeypatch.setenv("MDTPU_RMSF_PALLAS", "1")
    run = dict(batch_size=16, transfer_dtype="int16")
    port = AlignedRMSF(u56, select=SEL, engine="fused").run(
        backend="torch", device="cpu", **run)
    ref = JAlignedRMSF(ju56, select=SEL, engine="fused").run(
        backend="jax", **run)
    np.testing.assert_allclose(port.results.rmsf,
                               np.asarray(ref.results.rmsf), atol=5e-4)
    np.testing.assert_allclose(port.results.average,
                               np.asarray(ref.results.average), atol=5e-4)


def test_pass2_reads_pass1_blocks_from_the_cache(u56):
    """Both passes go through the fused function, and pass 2 is served
    entirely from the blocks pass 1 left in the device block cache
    (block by block: ``scan_k=1``, the per-block schedule; the folded
    schedule is held in tests/test_torch_scan_fold.py)."""
    cache = DeviceBlockCache()
    calls = []
    real = fp.planar_sums

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)

    try:
        fp.planar_sums = counting
        AlignedRMSF(u56, select=SEL, engine="fused").run(
            backend="torch", device="cpu", batch_size=16,
            transfer_dtype="int16", block_cache=cache, scan_k=1)
    finally:
        fp.planar_sums = real
    n_blocks = 4                      # 56 frames at batch 16
    assert len(calls) == 2 * n_blocks
    assert all(s == (3, 16, 256) for s in calls)   # planar, padded
    assert cache.misses == n_blocks and cache.hits == n_blocks


def test_fused_run_is_bit_reproducible(u56):
    run = dict(backend="torch", device="cpu", batch_size=16,
               transfer_dtype="int16")
    # both runs start from the same adaptive int16 scale hints (the
    # reader keeps them from one run to the next), so they stage the
    # same bytes
    u56.trajectory.__dict__.pop("_quant_max_hints", None)
    a = AlignedRMSF(u56, select=SEL, engine="fused").run(**run)
    u56.trajectory.__dict__.pop("_quant_max_hints", None)
    b = AlignedRMSF(u56, select=SEL, engine="fused").run(**run)
    np.testing.assert_array_equal(a.results.rmsf, b.results.rmsf)


def test_executor_instance_gets_a_cache(u56, oracle56):
    exe = TorchExecutor(batch_size=16, device="cpu",
                        transfer_dtype="int16", scan_k=1)
    r = AlignedRMSF(u56, select=SEL, engine="fused").run(backend=exe)
    assert isinstance(exe.block_cache, DeviceBlockCache)
    assert exe.block_cache.hits == 4
    np.testing.assert_allclose(r.results.rmsf, oracle56, atol=1e-3)


def test_average_structure_wide_and_selection(u56):
    """The wide form (all atoms moved by the selection's fit) and the
    select_only form agree on the selection, and match the oracle."""
    sel = u56.select_atoms(SEL).indices
    wide = AverageStructure(u56, select=SEL).run(
        backend="torch", device="cpu", batch_size=16)
    lean = AverageStructure(u56, select=SEL, select_only=True).run(
        backend="torch", device="cpu", batch_size=16)
    oracle = AverageStructure(u56, select=SEL).run(backend="serial")
    pos = wide.results.positions
    assert pos.shape == (u56.atoms.n_atoms, 3)
    np.testing.assert_allclose(pos, oracle.results.positions, atol=1e-3)
    np.testing.assert_allclose(lean.results.positions, pos[sel], atol=1e-4)
    assert wide.results.universe.atoms.n_atoms == u56.atoms.n_atoms
    with pytest.raises(ValueError):
        AverageStructure(u56, select=SEL, engine="fused")


def test_plain_rmsf_matches_oracle(u56):
    ca = u56.select_atoms(SEL)
    dev = RMSF(ca).run(backend="torch", device="cpu", batch_size=16)
    ser = RMSF(ca).run(backend="serial")
    np.testing.assert_allclose(dev.results.rmsf, ser.results.rmsf,
                               atol=1e-4)


def test_engine_and_backend_vocabulary(u56):
    with pytest.raises(ValueError):
        AlignedRMSF(u56, select=SEL, engine="Fused")
    with pytest.raises(ValueError, match="unknown backend"):
        get_executor("jax")
    with pytest.raises(ValueError):
        TorchExecutor(device="cpu", transfer_dtype="bf16")
    assert isinstance(get_executor("torch", device="cpu"), TorchExecutor)
