"""The fused aligned-moments path at selection widths beyond the CUDA
kernel's single-read form (``ops/fused_planar.fused_max_atoms``: 587,008
int16, 663,040 int8 and 477,184 float32 atoms on 132 SMs), against the
JAX package, on the CPU.

There the JAX package's ``pallas_fused._core_planar`` leaves its Pallas
kernel (its envelope ends at 16,384 atoms) for its XLA form on the same
planar block, and the port's ``fused_planar._core_planar`` runs the
plain version of the kernel, whose wide mode takes these widths on the
card (tests/test_torch_cuda.py holds the two together there).  Inputs
are made with numpy from a seed and handed to both packages: the first
wide width of each dtype (one padding granule above its limit), a
per-frame inverse scale and a masked frame tail.  Tolerances are
``_assert_moments_close``'s (tests/test_torch_cuda.py), those of
tests/test_pallas_fused.py: 5e-4 on the mean, 5e-3 on M2.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdanalysis_mpi_tpu.ops import pallas_fused as pf  # noqa: E402
from mdanalysis_mpi_tpu.ops import pallas_rmsf as pr  # noqa: E402

from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp  # noqa: E402
from mdanalysis_mpi_tpu_torch.ops import fused_rmsf as fr  # noqa: E402

MEAN_TOL = 5e-4
M2_TOL = 5e-3
_TOP = {"int16": 32767.0, "int8": 127.0}


def _wide_case(B, S, dtype, valid_b, seed):
    """A reference of S atoms (all real) and B frames, each a rigid
    rotation and shift of it plus 0.3 Å noise, staged as (3, B, S)
    planes with a per-frame inverse scale → (numpy params, planes,
    inverse scales, frame mask)."""
    r = np.random.default_rng(seed)
    refc = (r.normal(size=(S, 3)) * 4).astype(np.float32)
    refc -= refc.mean(axis=0)
    masses = r.uniform(1, 12, size=S).astype(np.float32)
    params = pr.build_params(jnp.asarray(refc), jnp.zeros(3, jnp.float32),
                             jnp.asarray(masses), S, S)
    coords = np.empty((B, S, 3), np.float32)
    for b in range(B):
        U, _, Vt = np.linalg.svd(r.normal(size=(3, 3)))
        if np.linalg.det(U @ Vt) < 0:
            U[:, -1] *= -1
        coords[b] = (refc @ (U @ Vt).T.astype(np.float32)
                     + r.normal(size=(S, 3)).astype(np.float32) * 0.3
                     + r.normal(size=3).astype(np.float32) * 10)
    planes = np.ascontiguousarray(np.moveaxis(coords, 2, 0))   # (3, B, S)
    if dtype == "float32":
        inv = (1.0 + 0.01 * np.arange(B)).astype(np.float32)
        qp = (planes / inv[None, :, None]).astype(np.float32)
    else:
        inv = (np.abs(planes).max(axis=(0, 2)) / _TOP[dtype]).astype(
            np.float32)
        qp = np.rint(planes / inv[None, :, None]).astype(dtype)
    mask = np.zeros(B, np.float32)
    mask[:valid_b] = 1.0
    return tuple(np.asarray(p) for p in params), qp, inv, mask


@pytest.mark.parametrize("dtype,itemsize", [("int16", 2), ("int8", 1),
                                            ("float32", 4)])
def test_first_wide_width_matches_the_jax_package(dtype, itemsize):
    S = fp.fused_max_atoms(itemsize, 132) + 256
    # the card's kernel takes this width in its wide mode
    assert len(fp.fused_geometry(6, S, itemsize, 132)) == 7
    np_params, qp, inv, mask = _wide_case(6, S, dtype, valid_b=5, seed=S)
    wN, refc_p, _, amask, sref = np_params
    t_j, sd_j, sq_j = pf._core_planar(
        "interpret", jnp.asarray(qp), jnp.asarray(inv), jnp.asarray(wN),
        jnp.asarray(refc_p), jnp.asarray(amask), jnp.asarray(sref),
        jnp.asarray(mask))
    twN, trefc_p, _, tamask, tsref = fr.params_from_numpy(*np_params,
                                                          device="cpu")
    t_t, sd_t, sq_t = fp._core_planar(
        torch.from_numpy(qp), torch.from_numpy(inv), twN, trefc_p, tamask,
        tsref, torch.from_numpy(mask))
    T = float(t_j)
    assert float(t_t) == T == 5.0
    sd_j, sq_j = np.asarray(sd_j), np.asarray(sq_j)
    sd_t, sq_t = sd_t.numpy(), sq_t.numpy()
    np.testing.assert_allclose(sd_t / T, sd_j / T, rtol=0, atol=MEAN_TOL)
    np.testing.assert_allclose(sq_t - sd_t ** 2 / T, sq_j - sd_j ** 2 / T,
                               rtol=0, atol=M2_TOL)
