"""Twin of ``tests/test_lib_transformations.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

lib.transformations — 4×4 homogeneous-matrix helpers (upstream
conventions: column vectors, radians, scalar-first quaternions,
axes-string Euler conventions)."""

import itertools
import math

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.lib import transformations as tf

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    assert_same, both, port_runs_on_the_cpu)


def _rand_rot(rng):
    a = rng.uniform(0, 2 * np.pi)
    d = rng.normal(size=3)
    return tf.rotation_matrix(a, d)


def test_identity_translation_scale():
    np.testing.assert_array_equal(tf.identity_matrix(), np.eye(4))
    t = tf.translation_matrix([1.0, -2.0, 3.0])
    np.testing.assert_allclose(t @ [0, 0, 0, 1], [1, -2, 3, 1])
    np.testing.assert_allclose(tf.translation_from_matrix(t), [1, -2, 3])
    s = tf.scale_matrix(2.0, origin=[1.0, 1.0, 1.0])
    # the origin is the fixed point of the scaling
    np.testing.assert_allclose(s @ [1, 1, 1, 1], [1, 1, 1, 1])
    np.testing.assert_allclose(s @ [2, 1, 1, 1], [3, 1, 1, 1])


def test_rotation_matrix_basics():
    r = tf.rotation_matrix(np.pi / 2, [0, 0, 1])
    np.testing.assert_allclose(r @ [1, 0, 0, 1], [0, 1, 0, 1], atol=1e-12)
    # about a point: that point is fixed
    rp = tf.rotation_matrix(1.1, [1, 2, 3], point=[4, 5, 6])
    np.testing.assert_allclose(rp @ [4, 5, 6, 1], [4, 5, 6, 1],
                               atol=1e-12)
    with pytest.raises(ValueError, match="nonzero"):
        tf.rotation_matrix(1.0, [0, 0, 0])


def test_rotation_from_matrix_round_trip():
    rng = np.random.default_rng(1)
    for _ in range(10):
        angle = rng.uniform(-np.pi + 0.05, np.pi - 0.05)
        direction = rng.normal(size=3)
        point = rng.normal(size=3)
        m = tf.rotation_matrix(angle, direction, point)
        a2, d2, p2 = tf.rotation_from_matrix(m)
        np.testing.assert_allclose(tf.rotation_matrix(a2, d2, p2), m,
                                   atol=1e-8)


def test_concatenate_is_right_to_left():
    t = tf.translation_matrix([1, 0, 0])
    r = tf.rotation_matrix(np.pi / 2, [0, 0, 1])
    # rotate first, then translate
    m = tf.concatenate_matrices(t, r)
    np.testing.assert_allclose(m @ [1, 0, 0, 1], [1, 1, 0, 1], atol=1e-12)


@pytest.mark.parametrize("axes", [
    "s" + "".join(p) for p in itertools.product("xyz", repeat=3)
    if p[0] != p[1] and p[1] != p[2]
] + ["r" + "".join(p) for p in itertools.product("xyz", repeat=3)
     if p[0] != p[1] and p[1] != p[2]])
def test_euler_round_trip_all_24_conventions(axes):
    # stable per-convention seed (hash() is salted per process and
    # would make a failing angle triple unreproducible)
    seed = sum(ord(c) * 7 ** i for i, c in enumerate(axes))
    rng = np.random.default_rng(seed)
    ai, aj, ak = rng.uniform(-1.2, 1.2, size=3)   # away from gimbal lock
    m = tf.euler_matrix(ai, aj, ak, axes)
    # a proper rotation
    np.testing.assert_allclose(m[:3, :3] @ m[:3, :3].T, np.eye(3),
                               atol=1e-12)
    got = tf.euler_from_matrix(m, axes)
    np.testing.assert_allclose(tf.euler_matrix(*got, axes), m, atol=1e-10)


def test_euler_static_xyz_convention_pinned():
    # sxyz: R = Rz(ak) @ Ry(aj) @ Rx(ai) (static axes compose left)
    ai, aj, ak = 0.3, -0.4, 0.9
    m = tf.euler_matrix(ai, aj, ak, "sxyz")
    expect = (tf.rotation_matrix(ak, [0, 0, 1])
              @ tf.rotation_matrix(aj, [0, 1, 0])
              @ tf.rotation_matrix(ai, [1, 0, 0]))
    np.testing.assert_allclose(m, expect, atol=1e-12)
    with pytest.raises(ValueError, match="axes"):
        tf.euler_matrix(0, 0, 0, "sxxz")


def test_quaternion_round_trip():
    rng = np.random.default_rng(7)
    for _ in range(12):
        m = _rand_rot(rng)
        q = tf.quaternion_from_matrix(m)
        assert q[0] >= 0.0 and abs(float(q @ q) - 1.0) < 1e-12
        np.testing.assert_allclose(tf.quaternion_matrix(q), m, atol=1e-10)
    # identity quaternion
    np.testing.assert_allclose(tf.quaternion_matrix([1, 0, 0, 0]),
                               np.eye(4), atol=1e-15)


def test_matches_rotateby_transformation():
    """The trajectory-level rotateby and the matrix helper must agree."""
    from mdanalysis_mpi_tpu_torch import transformations as trf
    from mdanalysis_mpi_tpu_torch.core.timestep import Timestep

    pos = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], np.float32)
    ts = Timestep(positions=pos.copy(), frame=0)
    trf.rotateby(37.0, [1, 1, 0], point=[1, 0, 0])(ts)
    m = tf.rotation_matrix(math.radians(37.0), [1, 1, 0], point=[1, 0, 0])
    hom = np.concatenate([pos.astype(np.float64),
                          np.ones((2, 1))], axis=1)
    np.testing.assert_allclose(ts.positions, (hom @ m.T)[:, :3],
                               atol=1e-5)


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


def _tf_cases():
    rng = np.random.default_rng(4)
    ang = rng.uniform(-np.pi, np.pi, size=3)
    d = rng.normal(size=3)
    pt = rng.normal(size=3)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    m = {
        "identity": lambda tf: tf.identity_matrix(),
        "translation": lambda tf: tf.translation_matrix(d),
        "translation_from": lambda tf: tf.translation_from_matrix(
            tf.translation_matrix(d)),
        "rotation": lambda tf: tf.rotation_matrix(ang[0], d, pt),
        "rotation_from": lambda tf: tf.rotation_from_matrix(
            tf.rotation_matrix(ang[0], d, pt)),
        "scale": lambda tf: tf.scale_matrix(1.7, pt),
        "concatenate": lambda tf: tf.concatenate_matrices(
            tf.rotation_matrix(ang[1], d), tf.translation_matrix(pt)),
        "quaternion_matrix": lambda tf: tf.quaternion_matrix(q),
        "quaternion_from": lambda tf: tf.quaternion_from_matrix(
            tf.rotation_matrix(ang[2], d)),
    }
    for axes in ("sxyz", "rzyx", "szxz", "ryxy"):
        m[f"euler_{axes}"] = (lambda tf, a=axes: tf.euler_matrix(*ang,
                                                                 axes=a))
        m[f"euler_from_{axes}"] = (lambda tf, a=axes: tf.euler_from_matrix(
            tf.euler_matrix(*ang, axes=a), axes=a))
    return m


_TF = _tf_cases()


@pytest.mark.parametrize("case", sorted(_TF))
def test_transformations_match_jax_package(case):
    assert_same(*both(lambda mod: _TF[case](mod("lib.transformations"))))
