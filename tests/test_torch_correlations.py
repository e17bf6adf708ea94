"""Twin of ``tests/test_correlations.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

lib.correlations (upstream public API): continuous-survival
autocorrelation over per-frame sets + intermittency preprocessing,
cross-checked against SurvivalProbability on the same data."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.lib.correlations import (
    autocorrelation, correct_intermittency,
)

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    assert_same, both, port_runs_on_the_cpu)


def test_hand_computed_survival():
    sets = [{1, 2}, {1}, {1, 2, 3}, {1, 2, 3}]
    taus, ts, data = autocorrelation(sets, tau_max=2)
    assert taus == [0, 1, 2]
    # tau=1 windows: {1,2}->{1}: 1/2; {1}->{1,2,3}: 1/1; {1,2,3} pair: 1
    np.testing.assert_allclose(ts, [1.0, (0.5 + 1 + 1) / 3,
                                    (0.5 + 1.0) / 2])
    # upstream shape: timeseries_data indexed by tau-1 (no tau=0 entry)
    assert len(data) == 2
    assert data[0] == [0.5, 1.0, 1.0]
    # tau_max beyond the trajectory: full-length, NaN-padded output
    taus4, ts4, data4 = autocorrelation(sets, tau_max=5)
    assert taus4 == [0, 1, 2, 3, 4, 5] and len(ts4) == 6
    assert np.isnan(ts4[4]) and np.isnan(ts4[5])
    assert data4[4] == []


def test_continuous_not_endpoint():
    """An element that leaves and returns does NOT survive the window
    crossing its absence."""
    sets = [{7}, set(), {7}]
    _, ts, _ = autocorrelation(sets, tau_max=2)
    # tau=2: only window start 0 has members; 7 absent at frame 1
    assert ts[2] == 0.0


def test_window_step():
    sets = [{1}, set(), {1}, set()]
    # window_step=2: starts 0 and 2 only; start 2's tau-1 window ends
    # at frame 3 where 1 is absent
    _, ts, data = autocorrelation(sets, tau_max=1, window_step=2)
    assert data[0] == [0.0, 0.0]
    _, ts1, data1 = autocorrelation(sets, tau_max=1, window_step=1)
    assert data1[0] == [0.0, 0.0]        # start 1 skipped (empty)


def test_correct_intermittency_sets():
    sets = [{1}, set(), {1}, set(), set(), {1}]
    filled = correct_intermittency(sets, 1)
    assert filled[1] == {1}              # single gap bridged
    assert filled[3] == set() and filled[4] == set()   # 2-gap stays
    filled2 = correct_intermittency(sets, 2)
    assert filled2[3] == {1} and filled2[4] == {1}
    # intermittency=0 is a pass-through copy
    same = correct_intermittency(sets, 0)
    assert same == [set() if not s else set(s) for s in sets]
    same[0].add(99)
    assert sets[0] == {1}                # no aliasing


def test_matches_survival_probability():
    """The library function and SurvivalProbability agree on the same
    membership data (they share the survival semantics)."""
    from mdanalysis_mpi_tpu_torch.analysis import SurvivalProbability
    from mdanalysis_mpi_tpu_torch.core.topology import Topology
    from mdanalysis_mpi_tpu_torch.core.universe import Universe
    from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

    IN, OUT = 2.0, 9.0
    frames = [(IN, IN, OUT), (IN, OUT, OUT), (IN, IN, IN),
              (OUT, IN, IN)]
    n = len(frames)
    pos = np.zeros((n, 4, 3), np.float32)
    for f, xs in enumerate(frames):
        for j, x in enumerate(xs):
            pos[f, j + 1] = [x, 0.0, 0.0]
    top = Topology(names=np.array(["CA", "OW", "OW", "OW"]),
                   resnames=np.array(["GLY", "SOL", "SOL", "SOL"]),
                   resids=np.arange(1, 5))
    u = Universe(top, MemoryReader(pos))
    sp = SurvivalProbability(u, "name OW and around 3.0 name CA").run(
        tau_max=3, backend="serial")
    sets = [{j for j, x in enumerate(xs) if x == IN} for xs in frames]
    _, ts, _ = autocorrelation(sets, tau_max=3)
    np.testing.assert_allclose(ts, sp.results.sp_timeseries)


def test_validation():
    with pytest.raises(ValueError, match="tau_max"):
        autocorrelation([{1}], tau_max=-1)
    with pytest.raises(ValueError, match="window_step"):
        autocorrelation([{1}], tau_max=1, window_step=0)
    with pytest.raises(ValueError, match="zero frames"):
        autocorrelation([], tau_max=1)
    with pytest.raises(ValueError, match="intermittency"):
        correct_intermittency([{1}], -1)


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k", [0, 1, 3])
def test_correlations_match_jax_package(seed, k):
    """Random presence masks and sets through both packages' helpers."""
    rng = np.random.default_rng(seed)
    mask = rng.random((30, 12)) < 0.6
    sets = [set(np.flatnonzero(row).tolist()) for row in mask]

    def case(mod):
        c = mod("lib.correlations")
        return (c.intermittency_filter(mask.copy(), k),
                [sorted(s) for s in c.correct_intermittency(
                    [set(s) for s in sets], k)],
                c.survival_windows(mask.copy(), 6),
                c.autocorrelation([set(s) for s in sets], 6,
                                  window_step=2))
    assert_same(*both(case))
