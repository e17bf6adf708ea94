"""Twin of ``tests/test_utils.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

Tests for the utils subsystem: phase timers, config, CLI.  The
reference's config and CLI cases (``TestConfig``, ``TestCLI``,
``TestRound5CLIAnalyses``, ``TestWaterbridgeCLI``) are twinned in
``tests/test_torch_cli.py``; the phase timers stay here.

The reference has none of this (observability = one print, RMSF.py:74;
config = hardcoded constants, RMSF.py:34,56,63,77); these tests pin the
framework's replacements (SURVEY.md §5.1/5.5/5.6).
"""

import pytest

from mdanalysis_mpi_tpu_torch.testing import make_protein_universe
from mdanalysis_mpi_tpu_torch.utils import TIMERS
from mdanalysis_mpi_tpu_torch.utils.timers import PhaseTimers

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    port_runs_on_the_cpu)


class TestPhaseTimers:
    def test_accumulates(self):
        t = PhaseTimers()
        with t.phase("a"):
            pass
        with t.phase("a"):
            pass
        with t.phase("b"):
            pass
        rep = t.report()
        assert rep["a"]["calls"] == 2
        assert rep["b"]["calls"] == 1
        assert rep["a"]["seconds"] >= 0

    def test_add_and_reset(self):
        t = PhaseTimers()
        t.add("x", 1.5)
        assert t.seconds("x") == 1.5
        t.reset()
        assert t.report() == {}

    def test_records_on_exception(self):
        t = PhaseTimers()
        with pytest.raises(RuntimeError):
            with t.phase("boom"):
                raise RuntimeError
        assert t.report()["boom"]["calls"] == 1

    def test_run_populates_global_timers(self):
        from mdanalysis_mpi_tpu_torch.analysis import RMSF

        TIMERS.reset()
        u = make_protein_universe(n_residues=4, n_frames=6, seed=3)
        RMSF(u.select_atoms("name CA")).run(backend="serial")
        rep = TIMERS.report()
        assert "prepare" in rep and "execute" in rep and "conclude" in rep


def test_phase_timers_match_jax_package():
    """The same phases through both packages' ``PhaseTimers``: equal
    names, call counts and added seconds (bookkeeping is host code)."""
    from mdanalysis_mpi_tpu.utils.timers import PhaseTimers as RefTimers

    out = []
    for t in (RefTimers(), PhaseTimers()):
        for name in ("stage", "dispatch", "stage", "wire"):
            with t.phase(name):
                pass
        t.add("conclude", 0.25)
        with pytest.raises(KeyError):
            with t.phase("failing"):
                raise KeyError("x")
        rep = t.report()
        out.append({k: (v["calls"], k == "conclude" and v["seconds"])
                    for k, v in rep.items()})
    assert out[0] == out[1]
