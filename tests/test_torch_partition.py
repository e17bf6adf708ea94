"""Twin of ``tests/test_partition.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

Frame-partitioner tests, incl. the reference's crash cases (Q2)."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.parallel.partition import (
    iter_batches, pad_batch, static_blocks,
)

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    assert_same, both, outcome, port_runs_on_the_cpu)


def test_static_blocks_balanced():
    # the reference's config (RMSF.py:66-69): 98 frames over 4 ranks
    blocks = static_blocks(98, 4)
    sizes = [len(b) for b in blocks]
    assert sum(sizes) == 98
    assert max(sizes) - min(sizes) <= 1     # balanced, unlike the reference
    # coverage is exact and ordered
    flat = [i for b in blocks for i in b]
    assert flat == list(range(98))


def test_static_blocks_more_blocks_than_frames():
    # Q2: size > n_frames crashes the reference with ZeroDivisionError
    blocks = static_blocks(3, 8)
    assert sum(len(b) for b in blocks) == 3
    assert sum(1 for b in blocks if len(b) == 0) == 5


def test_static_blocks_zero_frames():
    blocks = static_blocks(0, 4)
    assert all(len(b) == 0 for b in blocks)


def test_static_blocks_errors():
    with pytest.raises(ValueError):
        static_blocks(10, 0)
    with pytest.raises(ValueError):
        static_blocks(-1, 2)


def test_iter_batches():
    assert list(iter_batches(0, 10, 4)) == [(0, 4), (4, 8), (8, 10)]
    assert list(iter_batches(5, 5, 4)) == []
    with pytest.raises(ValueError):
        list(iter_batches(0, 10, 0))


def test_pad_batch():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    padded, mask = pad_batch(x, 5)
    assert padded.shape == (5, 3)
    np.testing.assert_array_equal(mask, [1, 1, 0, 0, 0])
    np.testing.assert_array_equal(padded[2], x[1])  # repeat last frame
    # exact size: no copy semantics change
    same, mask2 = pad_batch(x, 2)
    assert same is x
    assert mask2.sum() == 2
    # empty
    empty, mask3 = pad_batch(np.empty((0, 3), np.float32), 3)
    assert empty.shape == (3, 3)
    assert mask3.sum() == 0
    with pytest.raises(ValueError):
        pad_batch(x, 1)


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


@pytest.mark.parametrize("n_frames", [0, 1, 7, 64, 101])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_partition_matches_jax_package(n_frames, n):
    def case(mod):
        p = mod("parallel.partition")
        return (outcome(lambda: [list(r) for r in
                                  p.static_blocks(n_frames, n)]),
                outcome(lambda: list(p.iter_batches(0, n_frames, n))),
                outcome(lambda: p.pad_batch(
                    np.ones((max(n_frames % 5, 1), 3)), 5)))
    assert_same(*both(case))
