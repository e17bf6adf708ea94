"""Twin of ``tests/test_updating_groups.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

UpdatingAtomGroup (VERDICT r4 #6): ``select_atoms(..., updating=True)``.

Membership re-evaluates whenever the universe's current frame changes —
the general form of the reference's in-loop ``select_atoms``
(RMSF.py:126).  Pinned: per-frame membership of geometric selections
(table-driven), scoped (subgroup) updating selections, the
AnalysisFromFunction dynamic route, and the loud static-snapshot
refusal from ordinary analyses on every backend.
"""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch import UpdatingAtomGroup
from mdanalysis_mpi_tpu_torch.analysis import AnalysisFromFunction, RMSD
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    assert_same, both, port_runs_on_the_cpu)


IN, OUT = 2.0, 9.0          # inside / outside a 3 Å shell of the CA atom


def _universe(frames):
    """One fixed CA atom at the origin + three waters whose per-frame x
    positions are scripted, so shell membership is known exactly."""
    n = len(frames)
    pos = np.zeros((n, 4, 3), np.float32)
    for f, xs in enumerate(frames):
        for j, x in enumerate(xs):
            pos[f, j + 1] = [x, 0.0, 0.0]
    top = Topology(names=np.array(["CA", "OW", "OW", "OW"]),
                   resnames=np.array(["GLY", "SOL", "SOL", "SOL"]),
                   resids=np.array([1, 2, 3, 4]))
    return Universe(top, MemoryReader(pos))


# (frame layouts, expected member water indices per frame) — the
# table-driven contract: an `around`-based group changes membership
# across frames
CASES = [
    ([(IN, IN, OUT), (IN, OUT, OUT), (OUT, OUT, OUT), (IN, IN, IN)],
     [[1, 2], [1], [], [1, 2, 3]]),
    ([(OUT, OUT, OUT), (OUT, IN, OUT)],
     [[], [2]]),
]


@pytest.mark.parametrize("frames,expected", CASES)
def test_membership_tracks_frames(frames, expected):
    u = _universe(frames)
    shell = u.select_atoms("name OW and around 3.0 name CA", updating=True)
    assert isinstance(shell, UpdatingAtomGroup)
    seen = []
    for _ts in u.trajectory:
        seen.append(shell.indices.tolist())
        # positions re-gather through the same freshness check
        assert shell.positions.shape == (len(seen[-1]), 3)
        assert len(shell) == len(seen[-1])
    assert seen == expected
    # iterating again re-evaluates again (no stale terminal state)
    u.trajectory[0]
    assert shell.indices.tolist() == expected[0]


def test_static_group_stays_static():
    u = _universe([(IN, IN, OUT), (OUT, OUT, OUT)])
    static = u.select_atoms("name OW and around 3.0 name CA")
    assert static.indices.tolist() == [1, 2]
    u.trajectory[1]
    assert static.indices.tolist() == [1, 2]       # frozen, by contract


def test_scoped_updating_group():
    """updating selection within a subgroup: only that group's atoms are
    candidates (upstream scope semantics)."""
    u = _universe([(IN, IN, IN), (IN, OUT, IN)])
    two = u.atoms[[0, 1, 2]]                        # CA + first two waters
    shell = two.select_atoms("name OW and around 3.0 name CA",
                             updating=True)
    assert shell.indices.tolist() == [1, 2]
    u.trajectory[1]
    assert shell.indices.tolist() == [1]            # water 3 never eligible


def test_same_frame_single_evaluation():
    u = _universe([(IN, IN, OUT), (IN, OUT, OUT)])
    shell = u.select_atoms("name OW and around 3.0 name CA", updating=True)
    _ = shell.indices
    first = shell.indices
    # same frame: the SAME array object comes back (one evaluation)
    assert shell.indices is first
    u.trajectory[1]
    assert shell.indices is not first


def test_analysis_from_function_sees_updates():
    """The supported dynamic-membership analysis route: the user
    function reads the group per frame."""
    u = _universe([(IN, IN, OUT), (IN, OUT, OUT), (OUT, OUT, OUT)])
    shell = u.select_atoms("name OW and around 3.0 name CA", updating=True)
    r = AnalysisFromFunction(lambda ag: ag.n_atoms, shell).run(
        backend="serial")
    assert [int(v) for v in r.results.timeseries] == [2, 1, 0]


def test_snapshot_analyses_refuse_loudly():
    u = _universe([(IN, IN, OUT), (IN, OUT, OUT)])
    shell = u.select_atoms("name OW and around 3.0 name CA", updating=True)
    for backend in ("serial", "torch"):
        with pytest.raises(TypeError, match="UpdatingAtomGroup"):
            RMSD(shell).run(backend=backend)


def test_validates_eagerly():
    u = _universe([(IN, IN, OUT)])
    with pytest.raises(Exception):
        u.select_atoms("nmae OW", updating=True)


def test_nested_updating_group_tracks_base():
    """An updating selection whose BASE is itself updating must see the
    base's per-frame membership, not its creation-frame snapshot."""
    u = _universe([(IN, IN, OUT), (OUT, IN, IN)])
    shell = u.select_atoms("around 3.0 name CA", updating=True)
    nested = shell.select_atoms("name OW", updating=True)
    assert shell.indices.tolist() == [1, 2]
    assert nested.indices.tolist() == [1, 2]
    u.trajectory[1]
    assert shell.indices.tolist() == [2, 3]
    assert nested.indices.tolist() == [2, 3]      # tracks, not frozen


def test_duplicate_length_group_is_not_whole_universe():
    """A base group whose LENGTH happens to equal n_atoms (duplicates)
    must still scope the updating selection to its members."""
    u = _universe([(IN, IN, IN)])
    grp = u.atoms[[0, 0, 1, 2]]                   # len 4 == n_atoms; no 3
    shell = grp.select_atoms("name OW", updating=True)
    assert shell.indices.tolist() == [1, 2]       # atom 3 never eligible


def test_constructor_snapshot_analyses_refuse():
    """Dihedral/Contacts snapshot groups in __init__ and drop them —
    they must refuse an UpdatingAtomGroup there, since the run()-time
    scan cannot see a dropped group."""
    from mdanalysis_mpi_tpu_torch.analysis import Contacts, Dihedral

    u = _universe([(IN, IN, OUT), (IN, OUT, OUT)])
    uag = u.select_atoms("around 3.0 name CA", updating=True)
    with pytest.raises(TypeError, match="UpdatingAtomGroup"):
        Dihedral([uag])
    with pytest.raises(TypeError, match="UpdatingAtomGroup"):
        Contacts(u, select=("name OW", "name OW"), refgroup=(uag, uag))


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


@pytest.mark.parametrize("sel", ["name OW and around 4.0 protein",
                                 "resname SOL and prop z > 10",
                                 "byres (name OW and sphzone 6.0 protein)"])
def test_updating_membership_matches_jax_package(sel):
    """An updating group's members frame by frame, in each package."""
    def case(mod):
        u = mod("testing").make_solvated_universe(
            n_residues=5, n_waters=30, n_frames=4, seed=3)
        g = u.select_atoms(sel, updating=True)
        out = []
        for _ in u.trajectory:
            out.append(g.indices.copy())
        return out
    assert_same(*both(case))
