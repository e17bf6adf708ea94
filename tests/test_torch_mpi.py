"""The port's ``MPIExecutor`` and ``parallel/distributed.py`` helpers:
twins of tests/test_mpi_distributed.py (its MPIExecutor and distributed
cases) run on the port and, where they produce numbers, against the
JAX package's ``MPIExecutor`` over the same in-process communicator.

Each rank runs the serial float64 loop on its static frame block, so
the merged results match the serial oracle at the JAX package's
tolerances: RMSF rtol 1e-12, RMSD rtol 1e-10.
"""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from mdanalysis_mpi_tpu import analysis as jax_analysis  # noqa: E402
from mdanalysis_mpi_tpu import testing as jax_testing  # noqa: E402
from mdanalysis_mpi_tpu.parallel import (  # noqa: E402
    MPIExecutor as JaxMPIExecutor)

from mdanalysis_mpi_tpu_torch.analysis import RMSD, RMSF  # noqa: E402
from mdanalysis_mpi_tpu_torch.parallel import mpi  # noqa: E402
from mdanalysis_mpi_tpu_torch.parallel.distributed import (  # noqa: E402
    initialize, process_frame_shard, world)
from mdanalysis_mpi_tpu_torch.parallel.executors import (  # noqa: E402
    get_executor)
from mdanalysis_mpi_tpu_torch.parallel.mpi import (  # noqa: E402
    MPIExecutor, ThreadComm)
from mdanalysis_mpi_tpu_torch.testing import (  # noqa: E402
    make_protein_universe)


def _run_ranks(size, make_analysis, executor_cls=MPIExecutor,
               comm_cls=ThreadComm):
    """SPMD harness: one thread per rank, each with its own Universe
    copy (the reference's N independent reader handles, RMSF.py:56).
    Every join is bounded."""
    comms = comm_cls.make(size)
    results = [None] * size
    errors = []

    def rank_main(r):
        try:
            a = make_analysis(r)
            a.run(backend=executor_cls(comm=comms[r]))
            results[r] = a
        except Exception as e:      # pragma: no cover - surfaced below
            errors.append((r, e))

    threads = [threading.Thread(target=rank_main, args=(r,))
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    assert not errors, errors
    return results


def _jax_ranks(size, make_analysis):
    from mdanalysis_mpi_tpu.parallel import ThreadComm as JaxThreadComm

    return _run_ranks(size, make_analysis, JaxMPIExecutor, JaxThreadComm)


@pytest.mark.parametrize("size", [1, 3, 4])
def test_rmsf_matches_serial_oracle(size):
    u0 = make_protein_universe(n_residues=8, n_frames=13, seed=1)
    serial = RMSF(u0.select_atoms("name CA")).run(backend="serial")
    ranks = _run_ranks(
        size, lambda r: RMSF(u0.copy().select_atoms("name CA")))
    uj = jax_testing.make_protein_universe(n_residues=8, n_frames=13,
                                           seed=1)
    jranks = _jax_ranks(
        size, lambda r: jax_analysis.RMSF(uj.copy().select_atoms("name CA")))
    for a, j in zip(ranks, jranks):
        # every rank holds the full merged result (allreduce)
        np.testing.assert_allclose(a.results.rmsf, serial.results.rmsf,
                                   rtol=1e-12)
        np.testing.assert_allclose(a.results.rmsf, j.results.rmsf,
                                   rtol=1e-12)


def test_timeseries_concatenates_in_rank_order():
    u0 = make_protein_universe(n_residues=6, n_frames=11, seed=2)
    serial = RMSD(u0.select_atoms("name CA")).run(backend="serial")
    ranks = _run_ranks(3, lambda r: RMSD(u0.copy().select_atoms("name CA")))
    uj = jax_testing.make_protein_universe(n_residues=6, n_frames=11, seed=2)
    jranks = _jax_ranks(
        3, lambda r: jax_analysis.RMSD(uj.copy().select_atoms("name CA")))
    for a, j in zip(ranks, jranks):
        np.testing.assert_allclose(a.results.rmsd, serial.results.rmsd,
                                   rtol=1e-10)
        np.testing.assert_allclose(a.results.rmsd, j.results.rmsd,
                                   rtol=1e-10)


def test_more_ranks_than_frames():
    """Quirk Q2: empty blocks contribute identity partials instead of
    the reference's ZeroDivisionError."""
    u0 = make_protein_universe(n_residues=4, n_frames=2, seed=3)
    serial = RMSF(u0.select_atoms("name CA")).run(backend="serial")
    ranks = _run_ranks(5, lambda r: RMSF(u0.copy().select_atoms("name CA")))
    np.testing.assert_allclose(ranks[0].results.rmsf, serial.results.rmsf,
                               rtol=1e-12)


def test_missing_mpi4py_message():
    with pytest.raises(RuntimeError, match="mpi4py"):
        MPIExecutor()


def test_registered_backend_name():
    comms = ThreadComm.make(1)
    exe = get_executor("mpi", comm=comms[0])
    assert exe.name == "mpi"


def test_tree_helpers_match_the_pytree_maps():
    parts = [(np.arange(2.0), np.ones((2, 3))),
             (np.arange(3.0), np.zeros((3, 3)))]
    cat = mpi._tree_concat(parts)
    np.testing.assert_array_equal(cat[0], [0, 1, 0, 1, 2])
    assert cat[1].shape == (5, 3)
    leaves = mpi._tree_leaves(((np.zeros(4), 1.0), [np.ones(2)]))
    assert len(leaves) == 3 and mpi._n_rows(((np.zeros(4),),)) == 4


def test_initialize_single_process_noop():
    initialize(num_processes=1)      # must not raise or reconfigure
    initialize()                     # no cluster in the environment
    assert world() == (0, 1)


def test_initialize_needs_all_three_or_none():
    with pytest.raises(ValueError, match="together"):
        initialize(coordinator_address="127.0.0.1:1", num_processes=2)


@pytest.mark.parametrize("device, bound, backend", [
    ("cuda", None, "nccl"), ("cuda:1", 1, "nccl"), ("cpu", None, "gloo")])
def test_initialize_binds_an_indexed_card(monkeypatch, device, bound,
                                          backend):
    """A rank on ``cuda:N`` makes card N current before the group forms
    (NCCL binds a rank to its card); a bare ``cuda`` keeps the current
    card.  The backend follows the device."""
    import torch
    import torch.distributed as dist

    from mdanalysis_mpi_tpu_torch import device as dev_mod

    calls = {}

    def set_device(d):
        # torch.cuda.set_device refuses a device without an index
        if d.index is None:
            raise ValueError(f"no index in {d}")
        calls["set"] = d.index

    monkeypatch.setattr(dev_mod, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.setdefault("init", kw))
    initialize("127.0.0.1:1", 2, 0, device=device)
    assert calls.get("set") == bound
    assert calls["init"]["backend"] == backend
    assert calls["init"]["init_method"] == "tcp://127.0.0.1:1"
    assert (calls["init"]["world_size"], calls["init"]["rank"]) == (2, 0)


def test_process_frame_shard_partition():
    shards = [process_frame_shard(10, process_id=p, num_processes=3)
              for p in range(3)]
    assert [list(s) for s in shards] == [
        [0, 1, 2, 3], [4, 5, 6], [7, 8, 9]]
    flat = [i for s in shards for i in s]
    assert flat == list(range(10))
    assert list(process_frame_shard(4)) == [0, 1, 2, 3]
