"""The port's auxiliary series (``auxiliary.py``, a copy of the JAX
package's, and the reader's ``ts.aux`` surface, ``io/base.py``): the
JAX package's tests/test_auxiliary.py case by case, and the values a
frame carries EQUAL to the JAX package's on the same series."""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.auxiliary import ArrayAuxReader, XVGReader
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

XVG = """\
# GROMACS pull force
@    title "Pull force"
@    xaxis  label "Time (ps)"
@ s0 legend "force"
0.0   1.5   10.0
0.5   2.5   20.0
1.0   3.5   30.0
2.0   4.5   40.0
"""


def _universe(times):
    n = len(times)
    pos = np.zeros((n, 2, 3), np.float32)
    top = Topology(names=np.array(["CA", "CB"]),
                   resnames=np.array(["ALA", "ALA"]),
                   resids=np.array([1, 1]))
    return Universe(top, MemoryReader(pos, times=np.asarray(times,
                                                            np.float32)))


def test_xvg_parsing(tmp_path):
    p = tmp_path / "force.xvg"
    p.write_text(XVG)
    aux = XVGReader(str(p))
    assert aux.n_steps == 4
    np.testing.assert_allclose(aux.times, [0.0, 0.5, 1.0, 2.0])
    np.testing.assert_allclose(aux.data[:, 1], [1.5, 2.5, 3.5, 4.5])
    # grace dataset separator ends the series
    p2 = tmp_path / "two.xvg"
    p2.write_text("0 1\n1 2\n&\n0 99\n")
    assert XVGReader(str(p2)).n_steps == 2
    with pytest.raises(ValueError, match="non-numeric"):
        bad = tmp_path / "bad.xvg"
        bad.write_text("0.0 not_a_number\n")
        XVGReader(str(bad))
    with pytest.raises(ValueError, match="no data"):
        empty = tmp_path / "empty.xvg"
        empty.write_text("# only comments\n")
        XVGReader(str(empty))
    with pytest.raises(ValueError, match="ragged"):
        ragged = tmp_path / "ragged.xvg"
        ragged.write_text("0 1 2\n1 2\n")
        XVGReader(str(ragged))


def test_closest_step_and_cutoff():
    aux = ArrayAuxReader([0.0, 1.0, 3.0], [[0.0, 10], [1.0, 20],
                                           [3.0, 30]])
    assert aux.closest_step(-5.0) == 0
    assert aux.closest_step(0.4) == 0
    assert aux.closest_step(0.6) == 1
    assert aux.closest_step(2.1) == 2
    assert aux.closest_step(99.0) == 2
    np.testing.assert_allclose(aux.value_at(0.9), [1.0, 20])
    # cutoff: a frame farther than cutoff from every step reads NaN
    v = aux.value_at(2.0, cutoff=0.5)
    assert np.isnan(v).all()
    np.testing.assert_allclose(aux.value_at(2.9, cutoff=0.5), [3.0, 30])
    with pytest.raises(ValueError, match="non-decreasing"):
        ArrayAuxReader([1.0, 0.0], [[1], [2]])
    with pytest.raises(ValueError, match="empty"):
        ArrayAuxReader([], np.empty((0, 1)))


def test_trajectory_aux_surface(tmp_path):
    p = tmp_path / "force.xvg"
    p.write_text(XVG)
    u = _universe(times=[0.0, 1.0, 2.0])
    u.trajectory.add_auxiliary("force", XVGReader(str(p)))
    seen = [float(ts.aux.force[1]) for ts in u.trajectory]
    assert seen == [1.5, 3.5, 4.5]
    # two auxiliaries coexist; frames carry both
    u.trajectory.add_auxiliary(
        "cv", ArrayAuxReader([0.0, 2.0], [[0.0, 7], [2.0, 9]]))
    ts = u.trajectory[2]
    assert float(ts.aux.force[1]) == 4.5
    assert float(ts.aux.cv[1]) == 9.0
    with pytest.raises(AttributeError, match="attached"):
        ts.aux.nope
    with pytest.raises(ValueError, match="already attached"):
        u.trajectory.add_auxiliary("force", XVGReader(str(p)))
    u.trajectory.remove_auxiliary("cv")
    with pytest.raises(ValueError, match="no auxiliary"):
        u.trajectory.remove_auxiliary("cv")
    with pytest.raises(TypeError, match="value_at"):
        u.trajectory.add_auxiliary("bad", object())


def test_aux_cutoff_on_trajectory():
    u = _universe(times=[0.0, 5.0])
    u.trajectory.add_auxiliary(
        "e", ArrayAuxReader([0.0], [[0.0, 42.0]]), cutoff=1.0)
    assert float(u.trajectory[0].aux.e[1]) == 42.0
    assert np.isnan(u.trajectory[1].aux.e).all()


def test_plain_frames_have_no_aux():
    u = _universe(times=[0.0, 1.0])
    assert u.trajectory[0].aux is None


def test_scalar_series_and_bad_shapes():
    aux = ArrayAuxReader([0.0, 1.0, 2.0], [5.0, 6.0, 7.0])   # 1-D data
    assert aux.n_steps == 3
    np.testing.assert_allclose(aux.value_at(1.2), [6.0])
    with pytest.raises(ValueError, match="data"):
        ArrayAuxReader([0.0], np.zeros((1, 2, 2)))


def test_dict_method_names_rejected():
    u = _universe(times=[0.0])
    aux = ArrayAuxReader([0.0], [1.0])
    for bad in ("values", "items", "copy", "not an identifier"):
        with pytest.raises(ValueError, match="identifier"):
            u.trajectory.add_auxiliary(bad, aux)


def test_remove_auxiliary_refreshes_cursor():
    u = _universe(times=[0.0])
    u.trajectory.add_auxiliary("e", ArrayAuxReader([0.0], [42.0]))
    assert float(u.trajectory.ts.aux.e[0]) == 42.0
    u.trajectory.remove_auxiliary("e")
    assert u.trajectory.ts.aux is None          # no stale aux view


def test_timestep_copy_keeps_aux():
    u = _universe(times=[0.0])
    u.trajectory.add_auxiliary("e", ArrayAuxReader([0.0], [42.0]))
    snap = u.trajectory.ts.copy()
    assert float(snap.aux.e[0]) == 42.0


def test_chain_refuses_child_auxiliaries(tmp_path):
    from mdanalysis_mpi_tpu_torch.io.chain import ChainReader
    from mdanalysis_mpi_tpu_torch.io.xtc import write_xtc, XTCReader

    rng = np.random.default_rng(3)
    frames = rng.normal(size=(3, 5, 3)).astype(np.float32)
    p1, p2 = str(tmp_path / "a.xtc"), str(tmp_path / "b.xtc")
    write_xtc(p1, frames, times=np.array([0.0, 1.0, 2.0], np.float32))
    write_xtc(p2, frames, times=np.array([3.0, 4.0, 5.0], np.float32))
    child = XTCReader(p1)
    child.add_auxiliary("e", ArrayAuxReader([0.0], [1.0]))
    chain = ChainReader([child, XTCReader(p2)])
    with pytest.raises(ValueError, match="auxiliaries"):
        chain[0]
    # attached to the CHAIN itself (continuous times) it aligns
    # GLOBALLY: frame 4's time is 4.0, in the second segment
    chain2 = ChainReader([XTCReader(p1), XTCReader(p2)])
    chain2.add_auxiliary(
        "e", ArrayAuxReader(np.arange(6.0), np.arange(6.0) * 10))
    assert float(chain2[4].aux.e[0]) == 40.0
    # segment clocks that RESTART are refused: alignment by time would
    # silently hand segment-2 frames the aux records of segment 1
    p3 = str(tmp_path / "c.xtc")
    write_xtc(p3, frames, times=np.array([0.0, 1.0, 2.0], np.float32))
    chain3 = ChainReader([XTCReader(p1), XTCReader(p3)])
    with pytest.raises(ValueError, match="non-decreasing"):
        chain3.add_auxiliary("e", ArrayAuxReader([0.0], [1.0]))


def test_aux_values_are_copies():
    """Mutating ts.aux.<name> must not corrupt the series."""
    aux = ArrayAuxReader([0.0], [[0.0, 42.0]])
    u = _universe(times=[0.0])
    u.trajectory.add_auxiliary("e", aux)
    ts = u.trajectory[0]
    ts.aux.e[1] = -1.0
    assert float(u.trajectory[0].aux.e[1]) == 42.0
    assert aux.data[0, 1] == 42.0


def test_attach_preserves_current_frame():
    """add/remove_auxiliary must not silently rewind the cursor."""
    u = _universe(times=[0.0, 1.0, 2.0])
    u.trajectory[2]
    u.trajectory.add_auxiliary("e", ArrayAuxReader([0.0, 2.0],
                                                   [1.0, 9.0]))
    assert u.trajectory.ts.frame == 2
    assert float(u.trajectory.ts.aux.e[0]) == 9.0
    u.trajectory.remove_auxiliary("e")
    assert u.trajectory.ts.frame == 2
    assert u.trajectory.ts.aux is None


def test_edr_closed_with_guidance(tmp_path):
    """EDR is a documented conversion path, not a parser: the error
    carries the gmx recipe (the TPR/H5MD closure pattern)."""
    from mdanalysis_mpi_tpu_torch.auxiliary import EDRReader

    p = tmp_path / "ener.edr"
    p.write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError, match="gmx energy"):
        EDRReader(str(p))


def test_aux_values_equal_jax_package(tmp_path):
    from mdanalysis_mpi_tpu.auxiliary import XVGReader as JXVG
    from mdanalysis_mpi_tpu.core.topology import Topology as JTop
    from mdanalysis_mpi_tpu.core.universe import Universe as JU
    from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMR

    p = tmp_path / "f.xvg"
    p.write_text(XVG)
    times = np.array([0.0, 0.3, 0.9, 1.6, 2.4, 3.0], np.float32)
    u = _universe(times)
    u.trajectory.add_auxiliary("force", XVGReader(str(p)), cutoff=0.4)
    top = u.topology
    uj = JU(JTop(names=top.names, resnames=top.resnames,
                 resids=top.resids),
            JMR(np.zeros((len(times), 2, 3), np.float32), times=times))
    uj.trajectory.add_auxiliary("force", JXVG(str(p)), cutoff=0.4)
    for f in range(len(times)):
        np.testing.assert_array_equal(u.trajectory[f].aux.force,
                                      uj.trajectory[f].aux.force)

