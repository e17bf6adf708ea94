"""The port's ``transformations``, ``lib.transformations`` and
``lib.correlations`` (host code copied from the JAX package) against
the JAX package's, one twin test per public name: the same seeded
universes through the same transformation give EQUAL positions at every
frame, and the matrix and correlation helpers EQUAL outputs (the cases
of tests/test_transformations.py, test_lib_transformations.py and
test_correlations.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from mdanalysis_mpi_tpu import transformations as jtrf  # noqa: E402
from mdanalysis_mpi_tpu.core.topology import Topology as JTopology  # noqa: E402
from mdanalysis_mpi_tpu.core.universe import Universe as JUniverse  # noqa: E402
from mdanalysis_mpi_tpu.io.memory import MemoryReader as JMemoryReader  # noqa: E402
from mdanalysis_mpi_tpu.lib import correlations as jcorr  # noqa: E402
from mdanalysis_mpi_tpu.lib import transformations as jtf  # noqa: E402
from mdanalysis_mpi_tpu.testing import (  # noqa: E402
    make_protein_universe as jmake_protein_universe)

from mdanalysis_mpi_tpu_torch import transformations as trf  # noqa: E402
from mdanalysis_mpi_tpu_torch.core.topology import Topology  # noqa: E402
from mdanalysis_mpi_tpu_torch.core.universe import Universe  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader  # noqa: E402
from mdanalysis_mpi_tpu_torch.lib import correlations as corr  # noqa: E402
from mdanalysis_mpi_tpu_torch.lib import transformations as tf  # noqa: E402
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe  # noqa: E402

PORT = (Topology, Universe, MemoryReader, make_protein_universe, trf)
JAX = (JTopology, JUniverse, JMemoryReader, jmake_protein_universe, jtrf)


def _protein(pkg, box=30.0, n_frames=5):
    return pkg[3](n_residues=4, n_frames=n_frames, box=box, seed=4)


def _chain(pkg, n_frames=5, box=10.0):
    """Bonded 3-atom molecules drifting across a 10 Å box (unwrap,
    wrap, NoJump)."""
    rng = np.random.default_rng(8)
    base = np.array([[1.0, 5.0, 5.0], [1.9, 5.0, 5.0], [2.8, 5.0, 5.0]])
    steps = np.cumsum(rng.normal(scale=0.9, size=(n_frames, 1, 3)), 0)
    pos = ((base[None] + steps) % box).astype(np.float32)
    top = pkg[0](names=np.array(["C1", "C2", "C3"]),
                 resnames=np.full(3, "MOL"), resids=np.full(3, 1),
                 masses=np.array([12.0, 14.0, 16.0]),
                 bonds=np.array([[0, 1], [1, 2]]))
    dims = np.array([box, box, box, 90, 90, 90], np.float32)
    return pkg[1](top, pkg[2](pos, dimensions=dims))


def _build(name, pkg, u):
    t = pkg[4]
    ref = _protein(pkg)
    ca = u.select_atoms("name CA") if name not in (
        "unwrap", "wrap") else u.atoms
    return {
        "translate": lambda: t.translate([1.0, -2.0, 0.5]),
        "rotateby_point": lambda: t.rotateby(30.0, [1, 2, 3],
                                             point=[4, 5, 6]),
        "rotateby_group": lambda: t.rotateby(75.0, [0, 0, 1], ag=ca),
        "center_in_box": lambda: t.center_in_box(ca),
        "center_in_box_mass_wrap": lambda: t.center_in_box(
            ca, center="mass", wrap=True),
        "center_in_box_point": lambda: t.center_in_box(ca,
                                                       point=[1, 2, 3]),
        "fit_translation": lambda: t.fit_translation(
            ca, ref.select_atoms("name CA")),
        "fit_translation_plane": lambda: t.fit_translation(
            ca, ref.select_atoms("name CA"), plane="xy", weights="mass"),
        "fit_rot_trans": lambda: t.fit_rot_trans(
            ca, ref.select_atoms("name CA")),
        "fit_rot_trans_mass": lambda: t.fit_rot_trans(
            ca, ref.select_atoms("name CA"), weights="mass"),
        "unwrap": lambda: t.unwrap(ca),
        "wrap": lambda: t.wrap(ca),
        "PositionAverager": lambda: t.PositionAverager(avg_frames=3),
        "set_dimensions": lambda: t.set_dimensions([40.0, 41, 42, 90, 90,
                                                    90]),
        "NoJump": lambda: t.NoJump(),
    }[name]()


@pytest.mark.parametrize("name", [
    "translate", "rotateby_point", "rotateby_group", "center_in_box",
    "center_in_box_mass_wrap", "center_in_box_point", "fit_translation",
    "fit_translation_plane", "fit_rot_trans", "fit_rot_trans_mass",
    "unwrap", "wrap", "PositionAverager", "set_dimensions", "NoJump"])
def test_transformation_equal_to_jax(name):
    make = _chain if name in ("unwrap", "wrap", "NoJump") else _protein
    got = []
    for pkg in (PORT, JAX):
        u = make(pkg)
        u.trajectory.add_transformations(_build(name, pkg, u))
        seen = [(ts.positions.copy(), np.asarray(ts.dimensions))
                for ts in u.trajectory]
        got.append(tuple(np.stack(x) for x in zip(*seen)))
    np.testing.assert_array_equal(got[0][0], got[1][0])
    np.testing.assert_array_equal(got[0][1], got[1][1])
    assert np.isfinite(got[0][0]).all()


def test_validation_equal_to_jax():
    for pkg in (PORT, JAX):
        t = pkg[4]
        with pytest.raises(ValueError, match="exactly one"):
            t.rotateby(90.0, [0, 0, 1])
        with pytest.raises(ValueError, match="center"):
            t.center_in_box(None, center="middle")
        with pytest.raises(ValueError, match="plane"):
            t.fit_translation(None, None, plane="ab")
        u = _chain(pkg)
        u.topology.bonds = None
        with pytest.raises(ValueError, match="bond"):
            t.unwrap(u.atoms)
        with pytest.raises(ValueError):
            t.PositionAverager(avg_frames=0)


def test_make_whole_is_unwrap_at_one_frame():
    from mdanalysis_mpi_tpu_torch.lib.mdamath import make_whole

    u, uu = _chain(PORT), _chain(PORT)
    uu.trajectory.add_transformations(trf.unwrap(uu.atoms))
    for f in range(u.trajectory.n_frames):
        u.trajectory[f]
        np.testing.assert_array_equal(make_whole(u.atoms, inplace=False),
                                      uu.trajectory[f].positions)


class TestLibTransformations:
    def test_matrices_equal(self):
        rng = np.random.default_rng(2)
        for _ in range(5):
            angle = float(rng.uniform(-np.pi, np.pi))
            d = rng.normal(size=3)
            p = rng.normal(size=3)
            r = tf.rotation_matrix(angle, d, point=p)
            np.testing.assert_array_equal(r, jtf.rotation_matrix(angle, d,
                                                                 point=p))
            got, want = tf.rotation_from_matrix(r), jtf.rotation_from_matrix(r)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            q = tf.quaternion_from_matrix(r)
            np.testing.assert_array_equal(q, jtf.quaternion_from_matrix(r))
            np.testing.assert_array_equal(tf.quaternion_matrix(q),
                                          jtf.quaternion_matrix(q))
        np.testing.assert_array_equal(tf.identity_matrix(),
                                      jtf.identity_matrix())
        t = tf.translation_matrix([1.0, -2.0, 3.0])
        np.testing.assert_array_equal(t, jtf.translation_matrix([1.0, -2.0,
                                                                 3.0]))
        np.testing.assert_array_equal(tf.translation_from_matrix(t),
                                      jtf.translation_from_matrix(t))
        s = tf.scale_matrix(2.0, origin=[1.0, 1.0, 1.0])
        np.testing.assert_array_equal(
            s, jtf.scale_matrix(2.0, origin=[1.0, 1.0, 1.0]))
        np.testing.assert_array_equal(tf.concatenate_matrices(t, s),
                                      jtf.concatenate_matrices(t, s))
        assert tf.__all__ == jtf.__all__

    @pytest.mark.parametrize("axes", ["sxyz", "rzyx", "szxz", "ryxy"])
    def test_euler_equal(self, axes):
        m = tf.euler_matrix(0.3, -1.1, 2.0, axes)
        np.testing.assert_array_equal(m, jtf.euler_matrix(0.3, -1.1, 2.0,
                                                          axes))
        np.testing.assert_array_equal(tf.euler_from_matrix(m, axes),
                                      jtf.euler_from_matrix(m, axes))

    def test_errors_equal(self):
        for mod in (tf, jtf):
            with pytest.raises(ValueError, match="nonzero"):
                mod.rotation_matrix(1.0, [0, 0, 0])


class TestCorrelations:
    SETS = [{1, 2}, {1}, {1, 2, 3}, set(), {1, 2, 3}, {2, 3}, {1, 3}]

    @pytest.mark.parametrize("tau_max, step", [(2, 1), (5, 1), (9, 1),
                                               (3, 2)])
    def test_autocorrelation_equal(self, tau_max, step):
        got = corr.autocorrelation(self.SETS, tau_max, window_step=step)
        want = jcorr.autocorrelation(self.SETS, tau_max, window_step=step)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]

    @pytest.mark.parametrize("k", [0, 1, 2, 3])
    def test_intermittency_equal(self, k):
        assert (corr.correct_intermittency(self.SETS, k)
                == jcorr.correct_intermittency(self.SETS, k))
        rng = np.random.default_rng(k)
        mask = rng.random((12, 9)) < 0.5
        np.testing.assert_array_equal(corr.intermittency_filter(mask, k),
                                      jcorr.intermittency_filter(mask, k))

    @pytest.mark.parametrize("tau_max", [0, 3, 11])
    def test_survival_windows_equal(self, tau_max):
        mask = np.random.default_rng(7).random((12, 9)) < 0.6
        got = corr.survival_windows(mask, tau_max)
        want = jcorr.survival_windows(mask, tau_max)
        assert [list(map(float, v)) for v in got] == \
            [list(map(float, v)) for v in want]
