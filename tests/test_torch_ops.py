"""The port's superposition and moment ops (``ops/align.py``,
``ops/moments.py``) and its torch ``qcp_rotation`` against the JAX
package's functions, on the same numpy inputs made from a seed.

Tolerances: float32 on both sides, summed in other orders — 1e-5 on
unit-scale rotations and 1e-4 on coordinates of tens of Å.  SVD sign
conventions differ between ``torch.linalg.svd`` and
``jnp.linalg.svd``, so rotations and aligned coordinates are compared,
never U or V.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

# small shapes: one intra-op thread, so these tests leave the CPU to the
# other test workers' timing-sensitive tests
torch.set_num_threads(1)

from mdanalysis_mpi_tpu.ops import align as jalign  # noqa: E402
from mdanalysis_mpi_tpu.ops import moments as jmom  # noqa: E402
from mdanalysis_mpi_tpu.ops import pallas_fused as pf  # noqa: E402

from mdanalysis_mpi_tpu_torch.ops import align as talign  # noqa: E402
from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp  # noqa: E402
from mdanalysis_mpi_tpu_torch.ops import moments as tmom  # noqa: E402


def _rot(r, n):
    U, _, Vt = np.linalg.svd(r.normal(size=(n, 3, 3)))
    d = np.sign(np.linalg.det(U @ Vt))
    U[:, :, -1] *= d[:, None]
    return U @ Vt


def _frames(seed, B=12, N=40, noise=0.3):
    """A centred reference, masses, and B rigidly moved noisy copies."""
    r = np.random.default_rng(seed)
    ref = r.normal(scale=6.0, size=(N, 3))
    masses = r.uniform(1, 16, size=N)
    com = (ref * masses[:, None]).sum(0) / masses.sum()
    ref_c = ref - com
    rots = _rot(r, B)
    x = (np.einsum("ni,bji->bnj", ref, rots) + r.normal(size=(B, 1, 3)) * 5
         + r.normal(scale=noise, size=(B, N, 3)))
    f32 = np.float32
    return x.astype(f32), masses.astype(f32), ref_c.astype(f32), com.astype(f32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_weighted_center():
    x, m, _, _ = _frames(0)
    np.testing.assert_allclose(
        _np(talign.weighted_center(torch.from_numpy(x), torch.from_numpy(m))),
        _np(jalign.weighted_center(jnp.asarray(x), jnp.asarray(m))),
        atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kabsch_from_correlation_same_rotation(seed):
    r = np.random.default_rng(seed)
    H = r.normal(size=(16, 3, 3)).astype(np.float32)
    Rt = _np(talign.kabsch_from_correlation(torch.from_numpy(H)))
    Rj = _np(jalign.kabsch_from_correlation(jnp.asarray(H)))
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(Rt), 1.0, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_kabsch_rotation(weighted):
    x, m, ref_c, _ = _frames(3)
    xc = x - x.mean(axis=1, keepdims=True)
    wt = torch.from_numpy(m) if weighted else None
    wj = jnp.asarray(m) if weighted else None
    # the port batches over a leading frame axis; the JAX function takes
    # one frame
    Rt = _np(talign.kabsch_rotation(torch.from_numpy(xc),
                                    torch.from_numpy(ref_c), wt))
    Rj = np.stack([_np(jalign.kabsch_rotation(jnp.asarray(f),
                                              jnp.asarray(ref_c), wj))
                   for f in xc])
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)


def test_superpose_selection_batch():
    x, m, ref_c, com = _frames(4)
    at = _np(talign.superpose_selection_batch(
        *(torch.from_numpy(a) for a in (x, m, ref_c, com))))
    aj = _np(jalign.superpose_selection_batch(
        *(jnp.asarray(a) for a in (x, m, ref_c, com))))
    np.testing.assert_allclose(at, aj, atol=1e-4)
    # the aligned frames sit on the reference up to the added noise
    assert np.abs(at - (ref_c + com)).max() < 2.0


def test_superpose_batch_moves_all_atoms():
    x, m, ref_c, com = _frames(5, N=40)
    sel = np.arange(0, 40, 3)
    ref_sel = ref_c[sel] - (ref_c[sel] * m[sel, None]).sum(0) / m[sel].sum()
    at = _np(talign.superpose_batch(
        torch.from_numpy(x), torch.from_numpy(sel), torch.from_numpy(m[sel]),
        torch.from_numpy(ref_sel), torch.from_numpy(com)))
    aj = _np(jalign.superpose_batch(
        jnp.asarray(x), jnp.asarray(sel), jnp.asarray(m[sel]),
        jnp.asarray(ref_sel), jnp.asarray(com)))
    assert at.shape == x.shape
    np.testing.assert_allclose(at, aj, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_batch_moments(masked):
    x, _, _, _ = _frames(6)
    mask = np.ones(len(x), np.float32)
    mask[-3:] = 0.0
    mt = torch.from_numpy(mask) if masked else None
    mj = jnp.asarray(mask) if masked else None
    for a, b in zip(tmom.batch_moments(torch.from_numpy(x), mt),
                    jmom.batch_moments(jnp.asarray(x), mj)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-4)


def test_merge_reduce_and_rmsf():
    """Chan merge of block moments equals the moments of the whole
    trajectory, in torch (float32) and on numpy (float64) operands,
    and both match the JAX package."""
    x, _, _, _ = _frames(7, B=30)
    blocks = [x[0:7], x[7:19], x[19:30]]
    tparts = [tmom.batch_moments(torch.from_numpy(b)) for b in blocks]
    jparts = [jmom.batch_moments(jnp.asarray(b)) for b in blocks]
    t_t, mean_t, m2_t = tmom.reduce_moments(tparts)
    t_j, mean_j, m2_j = jmom.reduce_moments(jparts)
    whole = tmom.batch_moments(torch.from_numpy(x))
    assert float(t_t) == float(t_j) == 30.0
    for a, b, c in ((mean_t, mean_j, whole[1]), (m2_t, m2_j, whole[2])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(_np(a), _np(c), rtol=1e-5, atol=1e-4)
    r_t = tmom.rmsf_from_moments(t_t, m2_t)
    assert isinstance(r_t, torch.Tensor)
    np.testing.assert_allclose(_np(r_t),
                               _np(jmom.rmsf_from_moments(t_j, m2_j)),
                               rtol=1e-5)
    # numpy operands: the host float64 fold
    nparts = [(float(t), _np(mu).astype(np.float64),
               _np(m2).astype(np.float64)) for t, mu, m2 in tparts]
    t_n, _, m2_n = tmom.reduce_moments(nparts)
    np.testing.assert_allclose(tmom.rmsf_from_moments(t_n, m2_n), _np(r_t),
                               rtol=1e-5)
    with pytest.raises(ValueError):
        tmom.reduce_moments([])


def test_merge_with_empty_partial():
    x, _, _, _ = _frames(8)
    s = tmom.batch_moments(torch.from_numpy(x))
    z = torch.zeros_like(s[1])
    t, mean, m2 = tmom.merge_moments((torch.tensor(0.0), z, z), s)
    assert float(t) == float(s[0])
    torch.testing.assert_close(mean, s[1])
    torch.testing.assert_close(m2, s[2])


def _qcp_vs_svd(H):
    """(torch QCP R, JAX SVD R, JAX in-kernel QCP R) for (B, 3, 3) H."""
    r_qcp = torch.stack(fp.qcp_rotation(
        [torch.from_numpy(H[:, i, j]) for i in range(3) for j in range(3)]),
        dim=-1).reshape(-1, 3, 3).numpy()
    r_svd = np.asarray(jalign.kabsch_from_correlation(jnp.asarray(H)))
    r_jq = np.stack([np.asarray(v) for v in pf._qcp_rotation(
        [jnp.asarray(H[:, i, j]) for i in range(3) for j in range(3)],
        jnp)], axis=-1).reshape(-1, 3, 3)
    return r_qcp, r_svd, r_jq


@pytest.mark.parametrize("seed", [0, 1])
def test_qcp_rotation_matches_kabsch_on_aligned_coordinates(seed):
    """The torch QCP solve against the JAX SVD Kabsch: the same
    aligned coordinates to ~1e-5 (relative to the coordinate scale),
    and the JAX in-kernel QCP entry for entry."""
    x, m, ref_c, _ = _frames(seed, B=16)
    com = (x * m[None, :, None]).sum(1) / m.sum()
    xc = (x - com[:, None]).astype(np.float32)
    H = np.einsum("bni,nj->bij", xc, ref_c).astype(np.float32)
    r_qcp, r_svd, r_jq = _qcp_vs_svd(H)
    scale = np.abs(xc).max()
    aligned_qcp = np.einsum("bni,bij->bnj", xc, r_qcp)
    aligned_svd = np.einsum("bni,bij->bnj", xc, r_svd)
    assert np.abs(aligned_qcp - aligned_svd).max() / scale < 1e-5
    np.testing.assert_allclose(r_qcp, r_jq, atol=1e-6)


def test_qcp_rotation_degenerate_is_identity():
    H = np.zeros((2, 3, 3), np.float32)
    r_qcp, _, r_jq = _qcp_vs_svd(H)
    np.testing.assert_array_equal(r_qcp, np.broadcast_to(np.eye(3), (2, 3, 3)))
    np.testing.assert_array_equal(r_qcp, r_jq)


def _planar_case(rng, B, n_real, dtype):
    """Planes of a fused case on the CPU: a reference of coordinate
    scale 20 Å, each frame a rigid motion of it plus 0.3 Å noise,
    padded to 256 atoms → (the wrapper's arguments, T)."""
    from mdanalysis_mpi_tpu_torch.ops import fused_rmsf as fr

    idx_p, nr = fr.pad_selection(np.arange(n_real))
    S = len(idx_p)
    ref = rng.normal(scale=20.0, size=(n_real, 3))
    masses = rng.uniform(1, 16, size=n_real)
    com = (ref * (masses / masses.sum())[:, None]).sum(0)
    q, _ = np.linalg.qr(rng.normal(size=(B, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]
    x = (np.einsum("ni,bji->bnj", ref, q) + rng.normal(scale=10.0,
         size=(B, 1, 3)) + rng.normal(scale=0.3, size=(B, n_real, 3)))
    x = np.concatenate([x, np.repeat(x[:, :1], S - n_real, 1)], 1)
    planes = np.ascontiguousarray(np.moveaxis(x, 2, 0)).astype(np.float32)
    if dtype == "float32":
        qp, inv = planes, 1.0
    else:
        top = 32767.0 if dtype == "int16" else 127.0
        inv = float(np.abs(planes).max()) / top
        qp = np.round(planes / inv).astype(dtype)
    wN, refc_p, _, amask, sref = fr.build_params(ref - com, com, masses,
                                                 nr, S)
    valid = int(rng.integers(1, B + 1))
    fmask = np.zeros(B, np.float32)
    fmask[:valid] = 1.0
    args = (torch.from_numpy(qp), inv, wN, refc_p, amask, sref,
            torch.from_numpy(fmask))
    return args, float(valid)


def _sums_kabsch_f64(qp, inv, wN, refc_p, amask, sref, fmask):
    """The fused function in float64 with the rotation by SVD Kabsch:
    the oracle of the plain version's QCP solve."""
    x = qp.numpy().astype(np.float64) * inv                 # (3, B, S)
    x = np.moveaxis(x, 0, 2)                                 # (B, S, 3)
    w, ref = wN.double().numpy(), refc_p.double().numpy()
    com = np.einsum("bsi,s->bi", x, w)
    H = (np.einsum("bsi,sj->bij", x, ref)
         - com[:, :, None] * sref.double().numpy()[None, None, :])
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(U @ Vt))
    U[:, :, -1] *= d[:, None]
    R = U @ Vt
    dev = (np.einsum("bsi,bij->bsj", x - com[:, None], R) - ref[None]) \
        * amask.double().numpy()[None, :, None]
    fm = fmask.double().numpy()[:, None, None]
    return np.concatenate([(dev * fm).sum(0).T, (dev * dev * fm).sum(0).T])


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("dtype", ["float32", "int16", "int8"])
@pytest.mark.parametrize("n_real", [1, 2, 40])
def test_planar_sums_plain_holds_a_float64_kabsch(seed, dtype, n_real):
    """The fused kernel's plain version against the same function in
    float64 with an SVD Kabsch, at the kernel test's tolerances (mean
    5e-4, M2 5e-3).  Two atoms make the top eigenvalue of QCP's key
    matrix double (the rotation about their axis is free, and moves
    neither atom); a float32 solve, the TPU kernel's, misses there
    (:func:`test_two_atom_rotation_departs_from_the_tpu_kernel`), so
    the plain version and the kernel solve in float64."""
    rng = np.random.default_rng(seed)
    args, T = _planar_case(rng, int(rng.integers(2, 40)), n_real, dtype)
    out = fp.planar_sums_plain(*args).double().numpy()
    want = _sums_kabsch_f64(*args)
    np.testing.assert_allclose(out[:3] / T, want[:3] / T, rtol=0,
                               atol=5e-4)
    np.testing.assert_allclose(out[3:] - out[:3] ** 2 / T,
                               want[3:] - want[:3] ** 2 / T, rtol=0,
                               atol=5e-3)


@pytest.mark.parametrize("dtype", ["float32", "int16", "int8"])
def test_two_atom_rotation_departs_from_the_tpu_kernel(dtype):
    """The TPU kernel (``pallas_fused``'s planar kernel in interpret
    mode) on the two-atom cases that the plain version passes above: its
    float32 QCP misses the float64 SVD Kabsch beyond the same
    tolerances at one of the two seeds at least (ROADMAP §C, C5).  Here
    the port departs from its reference by design."""
    worst = 0.0
    for seed in range(2):
        args, T = _planar_case(np.random.default_rng(seed), 32, 2, dtype)
        want = _sums_kabsch_f64(*args)
        qp, inv, *rest = args
        assert pf._resolve_planar("interpret", qp.shape[1], qp.shape[2],
                                  dtype)[0] == "interpret"
        _, sum_d, sumsq = pf._core_planar(
            "interpret", jnp.asarray(qp.numpy()), inv,
            *(jnp.asarray(a.numpy()) for a in rest))
        got = np.concatenate([np.asarray(sum_d).T,
                              np.asarray(sumsq).T]).astype(np.float64)
        worst = max(worst,
                    np.abs(got[:3] / T - want[:3] / T).max() / 5e-4,
                    np.abs((got[3:] - got[:3] ** 2 / T)
                           - (want[3:] - want[:3] ** 2 / T)).max() / 5e-3)
    assert worst > 1.0
