"""Twin of ``tests/test_native_qcp.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

Native C++ QCP kernels vs the NumPy host implementations.

The reference's per-rank loop runs C qcprot + BLAS (RMSF.py:48,100);
trajio.cpp's QCP kernels are this framework's equivalent for the
serial/MPI host backends, and must agree with the NumPy twins to f64
round-off (same math: 4x4 quaternion key matrix, largest-eigenvalue
quaternion, row-vector rotation apply).
"""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.ops import host

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    assert_same, both, port_runs_on_the_cpu)


try:
    from mdanalysis_mpi_tpu_torch.io import native

    native.load()
    HAVE_NATIVE = True
except Exception:              # pragma: no cover - toolchain missing
    HAVE_NATIVE = False

pytestmark = pytest.mark.skipif(not HAVE_NATIVE,
                                reason="native library unavailable")

RNG = np.random.default_rng(11)


def _fixture(n=300, s=40, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.normal(scale=8.0, size=(n, 3)).astype(np.float32)
    sel = np.sort(rng.choice(n, size=s, replace=False)).astype(np.int64)
    w = rng.uniform(1.0, 16.0, size=s)
    ref = rng.normal(scale=8.0, size=(s, 3))
    ref_com = host.weighted_center(ref, w)
    return coords, sel, w, ref - ref_com, ref_com


def _numpy_superpose(coords, sel, w, ref_c, ref_com):
    sel_c = coords[sel].astype(np.float64)
    com = host.weighted_center(sel_c, w)
    r = host.qcp_rotation(sel_c - com, ref_c)
    return (coords.astype(np.float64) - com) @ r + ref_com, r


class TestNativeQCP:
    def test_superpose_apply_matches_numpy(self):
        coords, sel, w, ref_c, ref_com = _fixture()
        out, rot = native.qcp_superpose_apply(
            coords, sel, w, ref_c, ref_com, want_rot=True)
        exp, r = _numpy_superpose(coords, sel, w, ref_c, ref_com)
        # quaternion sign may flip between eigensolvers; R is unique
        np.testing.assert_allclose(rot, r, atol=1e-10)
        np.testing.assert_allclose(out, exp, atol=1e-8)

    def test_rotation_is_orthogonal(self):
        coords, sel, w, ref_c, ref_com = _fixture(seed=3)
        _, rot = native.qcp_superpose_apply(
            coords, sel, w, ref_c, ref_com, want_rot=True)
        np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-12)
        assert np.linalg.det(rot) == pytest.approx(1.0, abs=1e-12)

    def test_recovers_known_rotation(self):
        """Superposing a rotated copy of the reference must recover it."""
        rng = np.random.default_rng(4)
        s = 30
        ref = rng.normal(scale=5.0, size=(s, 3))
        w = np.ones(s)
        ref_com = ref.mean(axis=0)
        theta = 0.7
        rz = np.array([[np.cos(theta), -np.sin(theta), 0],
                       [np.sin(theta), np.cos(theta), 0], [0, 0, 1.0]])
        mobile = ((ref - ref_com) @ rz + np.array([3.0, -1.0, 2.0]))
        out = native.qcp_superpose_apply(
            mobile.astype(np.float32), np.arange(s, dtype=np.int64), w,
            ref - ref_com, ref_com)
        np.testing.assert_allclose(out, ref, atol=1e-5)   # f32 input noise

    def test_moments_matches_streaming(self):
        coords_frames = [RNG.normal(scale=6.0, size=(200, 3))
                        .astype(np.float32) for _ in range(7)]
        sel = np.arange(0, 200, 5, dtype=np.int64)
        w = RNG.uniform(1.0, 12.0, size=len(sel))
        ref = RNG.normal(scale=6.0, size=(len(sel), 3))
        ref_com = host.weighted_center(ref, w)
        ref_c = ref - ref_com

        stream_native = host.StreamingMoments((len(sel), 3))
        stream_numpy = host.StreamingMoments((len(sel), 3))
        for fr in coords_frames:
            native.qcp_superpose_moments(
                fr, sel, w, ref_c, ref_com,
                stream_native.t, stream_native.mean, stream_native.m2)
            stream_native.t += 1
            aligned, _ = _numpy_superpose(fr, sel, w, ref_c, ref_com)
            stream_numpy.update(aligned[sel])
        assert stream_native.t == stream_numpy.t
        np.testing.assert_allclose(stream_native.mean, stream_numpy.mean,
                                   atol=1e-9)
        np.testing.assert_allclose(stream_native.m2, stream_numpy.m2,
                                   atol=1e-8)

    def test_bad_selection_index_rejected(self):
        coords, sel, w, ref_c, ref_com = _fixture()
        sel = sel.copy()
        sel[0] = coords.shape[0]            # out of range
        with pytest.raises(RuntimeError):
            native.qcp_superpose_apply(coords, sel, w, ref_c, ref_com)

    def test_host_fallback_agrees_with_native(self, monkeypatch):
        """superpose_frame: MDTPU_NATIVE_HOST=0 NumPy path vs native."""
        coords, sel, w, ref_c, ref_com = _fixture(seed=9)
        fast = host.superpose_frame(coords, sel, w, ref_c, ref_com)
        monkeypatch.setattr(host, "_NATIVE", False)
        slow = host.superpose_frame(coords, sel, w, ref_c, ref_com)
        monkeypatch.setattr(host, "_NATIVE", None)
        np.testing.assert_allclose(fast, slow, atol=1e-8)


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("weighted", [False, True])
def test_qcp_matches_jax_package(seed, weighted):
    rng = np.random.default_rng(seed)
    ref_xyz = rng.normal(scale=5.0, size=(40, 3))
    mob = ref_xyz @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T
    mob += rng.normal(scale=0.2, size=mob.shape) + 3.0
    w = rng.uniform(1, 16, size=40) if weighted else None
    ref, port = both(lambda mod: mod("ops.host").qcp_rotation(
        mob, ref_xyz, w) if weighted else mod("ops.host").qcp_rotation(
        mob, ref_xyz))
    assert_same(ref, port)
