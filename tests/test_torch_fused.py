"""The port's fused aligned-moments path (``ops/fused_planar.py``,
``ops/fused_rmsf.py``) against the JAX package's planar Pallas kernel
run in interpret mode and its interleaved XLA form.

Inputs are made with numpy from a seed and handed to both packages;
the fused params cross over through ``fused_rmsf.params_from_numpy``
and staged blocks as their numpy bytes.  On the CPU the port's wrapper
runs the kernel's plain version, so these tests hold that plain version
(the CUDA kernel's arithmetic) to the TPU kernel.  Tolerances are those
of tests/test_pallas_fused.py: 5e-4 on the mean, 5e-3 on M2 and on the
pass-1 sums.  The CUDA kernel itself is held to its plain version by
tests/test_torch_cuda.py, which runs where a GPU is present.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

# small shapes: one intra-op thread, so these tests leave the CPU to the
# other test workers' timing-sensitive tests
torch.set_num_threads(1)

from mdanalysis_mpi_tpu.io.base import planar_repack as jax_planar_repack  # noqa: E402
from mdanalysis_mpi_tpu.ops import pallas_fused as pf  # noqa: E402
from mdanalysis_mpi_tpu.ops import pallas_rmsf as pr  # noqa: E402
from mdanalysis_mpi_tpu.parallel.executors import (  # noqa: E402
    quantize_block as jax_quantize_block,
    quantize_block_delta as jax_quantize_block_delta)

from mdanalysis_mpi_tpu_torch import _build  # noqa: E402
from mdanalysis_mpi_tpu_torch.io.base import planar_repack  # noqa: E402
from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp  # noqa: E402
from mdanalysis_mpi_tpu_torch.ops import fused_rmsf as fr  # noqa: E402


def _case(B, n_real, dtype="int16", seed=0, valid_b=None):
    """Rigid-rotated reference + noise (test_pallas_fused._planar_case),
    staged interleaved and planar: (jax params, numpy params, q, qp,
    inv, mask, n_real)."""
    r = np.random.default_rng(seed)
    pidx, nr = pr.pad_selection(np.arange(n_real))
    S = pidx.shape[0]
    refc = r.normal(size=(n_real, 3)) * 4
    refc -= refc.mean(axis=0)
    masses = r.uniform(1, 12, size=n_real)
    params = pr.build_params(
        jnp.asarray(refc, jnp.float32),
        jnp.asarray(refc.mean(axis=0), jnp.float32),
        jnp.asarray(masses, jnp.float32), nr, S)
    coords = np.zeros((B, S, 3), np.float64)
    for b in range(B):
        U, _, Vt = np.linalg.svd(r.normal(size=(3, 3)))
        if np.linalg.det(U @ Vt) < 0:
            U[:, -1] *= -1
        coords[b] = (refc @ (U @ Vt).T
                     + r.normal(size=(n_real, 3)) * 0.3
                     + r.normal(size=3) * 10)[pidx]
    q, inv = jax_quantize_block(coords.astype(np.float32), dtype)
    mask = np.zeros(B, np.float32)
    mask[:B if valid_b is None else valid_b] = 1.0
    np_params = tuple(np.asarray(p) for p in params)
    return (params, np_params, q, jax_planar_repack(q), np.float32(inv),
            mask, nr)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


MATRIX = [
    (16, 100, "int16", None),      # one TPU frame tile
    (32, 250, "int16", 30),        # masked tail frames
    (32, 250, "int8", None),       # int8 tier
    (48, 511, "int16", 47),        # S = 512, uneven tail
    (16, 256, "int16", None),      # exact-width selection (no padding)
]


@pytest.mark.parametrize("B,n_real,dtype,valid_b", MATRIX)
def test_plain_kernel_matches_pallas_interpret(B, n_real, dtype, valid_b):
    params, np_params, q, qp, inv, mask, nr = _case(
        B, n_real, dtype, seed=B + n_real, valid_b=valid_b)
    tparams = fr.params_from_numpy(*np_params, device="cpu")
    t_p, mean_p, m2_p = pf.moments_kernel_for("interpret", nr)(
        params, jnp.asarray(qp), inv, None, jnp.asarray(mask))
    t_t, mean_t, m2_t = fp.moments_kernel_for(nr)(
        tparams, _t(qp), inv, None, _t(mask))
    assert float(t_p) == float(t_t)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_p), atol=5e-4)
    np.testing.assert_allclose(m2_t.numpy(), np.asarray(m2_p), atol=5e-3)
    # pass-1 average function on the same planes
    t_ap, s_ap = pf.avg_kernel_for("interpret", nr)(
        params, jnp.asarray(qp), inv, None, jnp.asarray(mask))
    t_at, s_at = fp.avg_kernel_for(nr)(tparams, _t(qp), inv, None, _t(mask))
    assert float(t_ap) == float(t_at)
    np.testing.assert_allclose(s_at.numpy(), np.asarray(s_ap), atol=5e-3)


@pytest.mark.parametrize("B,n_real,dtype,valid_b", MATRIX)
def test_plain_kernel_matches_interleaved_xla(B, n_real, dtype, valid_b):
    """The planar plain version (QCP) and the port's interleaved SVD
    form (``fused_rmsf._core``) against the JAX package's XLA form."""
    params, np_params, q, qp, inv, mask, nr = _case(
        B, n_real, dtype, seed=B + n_real + 1, valid_b=valid_b)
    tparams = fr.params_from_numpy(*np_params, device="cpu")
    t_x, mean_x, m2_x = pr.moments_kernel_for("xla", nr)(
        params, jnp.asarray(q), inv, None, jnp.asarray(mask))
    t_t, mean_t, m2_t = fp.moments_kernel_for(nr)(
        tparams, _t(qp), inv, None, _t(mask))
    assert float(t_x) == float(t_t)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_x), atol=5e-4)
    np.testing.assert_allclose(m2_t.numpy(), np.asarray(m2_x), atol=5e-3)

    wN, refc_p, _, amask, sref = tparams
    _, sd_x, sq_x = pr._core("xla", jnp.asarray(q), inv, *(
        jnp.asarray(np_params[i]) for i in (0, 1, 3, 4)), jnp.asarray(mask))
    t_c, sd_c, sq_c = fr._core(_t(q), inv, wN, refc_p, amask, sref,
                               _t(mask))
    assert float(t_c) == float(t_x)
    np.testing.assert_allclose(sd_c.numpy(), np.asarray(sd_x), atol=5e-3)
    np.testing.assert_allclose(sq_c.numpy(), np.asarray(sq_x), atol=5e-3)


def test_delta_plain_kernel_matches_pallas_interpret():
    """The delta tier: the port's cumsum reconstruction feeding the
    plain planar sweep vs the JAX reconstruction feeding the
    interpret-mode kernel, on the same delta bytes."""
    params, np_params, _, _, _, mask, nr = _case(16, 100, "int16", seed=9)
    tparams = fr.params_from_numpy(*np_params, device="cpu")
    r = np.random.default_rng(9)
    block = r.normal(scale=8.0, size=(16, 256, 3)).astype(np.float32)
    res, dkey, inv_abs, inv_res = jax_quantize_block_delta(block, 1)
    jargs = (jnp.asarray(res), jnp.asarray(dkey), inv_abs, inv_res, None,
             jnp.asarray(mask))
    targs = (_t(res), _t(dkey), _t(inv_abs), _t(inv_res), None, _t(mask))
    t_p, mean_p, m2_p = pf.moments_delta_kernel_for("interpret", nr)(
        params, *jargs)
    t_t, mean_t, m2_t = fp.moments_delta_kernel_for(nr)(tparams, *targs)
    assert float(t_p) == float(t_t)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_p), atol=5e-4)
    np.testing.assert_allclose(m2_t.numpy(), np.asarray(m2_p), atol=5e-3)
    t_ap, s_ap = pf.avg_delta_kernel_for("interpret", nr)(params, *jargs)
    t_at, s_at = fp.avg_delta_kernel_for(nr)(tparams, *targs)
    assert float(t_ap) == float(t_at)
    np.testing.assert_allclose(s_at.numpy(), np.asarray(s_ap), atol=5e-3)


def test_per_frame_inv_scale_forms_agree():
    """A scalar inverse scale and its per-frame (B,), (B,1) and (B,1,1)
    forms give the same sums (``_core_planar``'s inv_scale contract)."""
    _, np_params, _, qp, inv, mask, _ = _case(16, 100, "int16", seed=3)
    wN, refc_p, _, amask, sref = fr.params_from_numpy(*np_params, "cpu")
    ref = fp.planar_sums(_t(qp), inv, wN, refc_p, amask, sref, _t(mask))
    for shape in ((16,), (16, 1), (16, 1, 1)):
        per_frame = torch.full(shape, float(inv))
        out = fp.planar_sums(_t(qp), per_frame, wN, refc_p, amask, sref,
                             _t(mask))
        torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_uneven_tail_rows_are_ignored():
    """Masked frames past the real ones contribute nothing, whatever
    they hold: garbage in the padded rows leaves the sums unchanged."""
    _, np_params, _, qp, inv, mask, _ = _case(32, 250, "int16", seed=5,
                                              valid_b=30)
    wN, refc_p, _, amask, sref = fr.params_from_numpy(*np_params, "cpu")
    clean = qp.copy()
    clean[:, 30:] = 0
    dirty = qp.copy()
    dirty[:, 30:] = np.random.default_rng(0).integers(
        -30000, 30000, size=dirty[:, 30:].shape)
    a = fp.planar_sums(_t(clean), inv, wN, refc_p, amask, sref, _t(mask))
    b = fp.planar_sums(_t(dirty), inv, wN, refc_p, amask, sref, _t(mask))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_routes_cpu_to_plain_and_counts_no_launch():
    _, np_params, _, qp, inv, mask, _ = _case(16, 100, "int8", seed=7)
    wN, refc_p, _, amask, sref = fr.params_from_numpy(*np_params, "cpu")
    n0 = fp.planar_sums.launches
    out = fp.planar_sums(_t(qp), inv, wN, refc_p, amask, sref, _t(mask))
    plain = fp.planar_sums_plain(_t(qp), inv, wN, refc_p, amask, sref,
                                 _t(mask))
    assert fp.planar_sums.launches == n0
    assert out.shape == (6, qp.shape[2]) and out.dtype == torch.float32
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


def test_wrapper_refuses_other_devices():
    _, np_params, _, qp, inv, mask, _ = _case(16, 100, "int16", seed=8)
    meta = [torch.empty(p.shape, device="meta")
            for p in fr.params_from_numpy(*np_params, "cpu")]
    with pytest.raises(ValueError, match="no kernel for device"):
        fp.planar_sums(torch.empty(qp.shape, dtype=torch.int16,
                                   device="meta"), inv, meta[0], meta[1],
                       meta[3], meta[4], torch.empty(16, device="meta"))


def test_planar_repack_matches_and_counts():
    q = np.arange(24, dtype=np.int16).reshape(2, 4, 3)
    from mdanalysis_mpi_tpu_torch.obs import METRICS

    def repacks():
        return sum(METRICS.snapshot().get(
            "mdtpu_fused_planar_repacks_total",
            {"values": {}})["values"].values())

    n0 = repacks()
    p = planar_repack(q)
    assert repacks() == n0 + 1
    assert p.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(p, np.asarray(jax_planar_repack(q)))


def test_routing_contract():
    """``quantized_batch``: None off the fused engine and for float32
    staging; planar functions for int16/int8; the delta functions for
    delta; a bad wire format raises; the engine vocabulary is the JAX
    package's."""
    assert fr.VALID_ENGINES == pr.VALID_ENGINES
    for bad in ("Fused", "pallas", "xla"):
        with pytest.raises(ValueError):
            fr.validate_engine(bad)
    idx = np.arange(100)
    ref = np.zeros((100, 3))
    args = (idx, ref, np.zeros(3), np.ones(100))
    assert fr.quantized_batch("moments", None, "int16", *args) is None
    assert fr.quantized_batch("moments", "auto", "int16", *args) is None
    assert fr.quantized_batch("moments", "fused", "float32", *args) is None
    with pytest.raises(ValueError):
        fr.quantized_batch("moments", "fused", "bf16", *args)
    for wire in ("int16", "int8"):
        fn, params, idx_p = fr.quantized_batch("avg", "fused", wire, *args)
        assert fn is fp.avg_kernel_for(100)
        assert fn.staging_layout == "planar"
        assert len(idx_p) == fr.ATOM_TILE and len(params) == 5
    fn, _, _ = fr.quantized_batch("moments", "fused", "delta", *args)
    assert fn is fp.moments_delta_kernel_for(100)


@pytest.mark.parametrize("n", [1, 100, 256, 257, 50000])
def test_pad_selection_matches_jax(n):
    idx = np.arange(n) * 2 + 1
    a, na = fr.pad_selection(idx)
    b, nb = pr.pad_selection(idx)
    assert na == nb
    np.testing.assert_array_equal(a, b)


def test_params_match_jax_build_params():
    r = np.random.default_rng(2)
    refc = r.normal(size=(100, 3))
    com = r.normal(size=3)
    masses = r.uniform(1, 12, size=100)
    jp = pr.build_params(jnp.asarray(refc, jnp.float32),
                         jnp.asarray(com, jnp.float32),
                         jnp.asarray(masses, jnp.float32), 100, 256)
    tp = fr.build_params(refc, com, masses, 100, 256)
    for a, b in zip(tp, jp):
        # float32 sums taken in another order: a few ulps of |Σref|
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-5)


def test_kernel_build_is_keyed_by_its_sources():
    """The build finds the CUDA source and keys the library by a hash
    of the sources and flags (nothing is compiled here)."""
    assert [s.rsplit("/", 1)[-1] for s in _build.sources()] == [
        "fused_rmsf.cu", "pair_histogram.cu"]
    path = _build.library_path()
    assert path.endswith(_build.LIB_NAME)
    assert path == _build.library_path()
    assert "build" in path.split("/")
