"""Twin of ``tests/test_delta_staging.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

Frame-delta residual wire format (VERDICT r4 #5).

``transfer_dtype='delta'`` stages one absolute int16 keyframe per
device shard plus closed-loop int8 residuals with per-frame scales.
Temporal correlation (real MD) shrinks the residual range, so int8
carries int16-like precision at ~half the wire bytes; a decorrelated
trajectory blows the range up and fails the ordinary divergence
discipline loudly instead of scoring (same contract as int8 staging).

Pinned here: the closed-loop error bound (NO random-walk accumulation),
pad-row and anchor-segment semantics, the ≤0.6× int16 wire-byte
criterion, jax + mesh parity against the serial f64 oracle, cache
reuse, and the multi-controller refusal.
"""

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF, RMSD
from mdanalysis_mpi_tpu_torch.parallel.executors import (
    DeviceBlockCache, MeshExecutor, quantize_block, quantize_block_delta,
)
from mdanalysis_mpi_tpu_torch.testing import make_md_universe

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    both, port_runs_on_the_cpu)


def _walk_block(b=32, s=40, step=0.05, scale=8.0, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(scale=scale, size=(s, 3))
    walk = np.cumsum(rng.normal(scale=step, size=(b, s, 3)), axis=0)
    return (base[None] + walk).astype(np.float32)


def _reconstruct(res, key, inv_abs, inv_res):
    """Host replica of _delta_wrapper's device math (one anchor)."""
    return (key.astype(np.float32) * inv_abs
            + np.cumsum(res.astype(np.float32) * inv_res, axis=0))


def test_closed_loop_error_bounded_per_frame():
    """Every frame's reconstruction error is bounded by ITS OWN residual
    step plus the keyframe step — no sqrt(t) random walk."""
    block = _walk_block(b=64)
    res, key, inv_abs, inv_res = quantize_block_delta(block)
    assert res.dtype == np.int8 and key.dtype == np.int16
    assert key.shape == (1,) + block.shape[1:]
    xhat = _reconstruct(res, key, inv_abs, inv_res)
    err = np.abs(xhat - block).max(axis=(1, 2))          # per frame
    bound = 0.51 * (inv_res[:, 0, 0] + inv_abs[0, 0, 0]) + 1e-5
    assert (err <= bound).all(), (err / bound).max()
    # the LAST frame is no worse than the bound either — accumulation
    # would show up exactly here
    assert err[-1] <= bound[-1]
    # correlated walk => residual scales are fine-grained: much finer
    # than the absolute int8 resolution (range/120) they replace
    assert inv_res[1:, 0, 0].max() < np.abs(block).max() / 120 / 5


def test_anchor_segments_and_pad_rows():
    block = _walk_block(b=32)
    # 4 anchors: each 8-frame segment anchored independently (the mesh
    # layout: one absolute keyframe per device shard)
    res, key, inv_abs, inv_res = quantize_block_delta(block, n_anchors=4)
    assert key.shape == (4,) + block.shape[1:]
    for a in range(4):
        seg = slice(a * 8, (a + 1) * 8)
        xhat = _reconstruct(res[seg], key[a:a + 1],
                            inv_abs[a:a + 1], inv_res[seg])
        bound = (0.51 * (inv_res[seg, 0, 0]
                         + inv_abs[a, 0, 0]) + 1e-5)
        assert (np.abs(xhat - block[seg]).max(axis=(1, 2)) <= bound).all()
        assert (res[seg][0] == 0).all()          # anchor row: no residual
    # pad rows (n_valid onward) carry zero residuals and unit scales
    res, key, inv_abs, inv_res = quantize_block_delta(block, n_valid=20)
    assert (res[20:] == 0).all()
    assert (inv_res[20:] == 1.0).all()
    with pytest.raises(ValueError, match="anchor"):
        quantize_block_delta(block, n_anchors=5)       # 32 % 5 != 0


def test_wire_bytes_vs_int16():
    """The done criterion: measured wire bytes/frame <= 0.6x int16 at
    the shipped batch geometries (ratio = 0.5 + 1/segment, so any
    anchor segment of >= 10 frames qualifies; flagship batches are 64
    frames per shard)."""
    block = _walk_block(b=64, s=200)
    res, key, _, _ = quantize_block_delta(block)
    q16, _ = quantize_block(block, "int16")
    ratio = (res.nbytes + key.nbytes) / q16.nbytes
    assert ratio <= 0.6, ratio
    # mesh layout: global batch 64 over 8 shards = 8-frame segments is
    # deliberately OVER the bound (0.625) — the saving needs real
    # per-shard batches; at the shipped mesh default (64/shard -> 512
    # global) the ratio is ~0.52
    big = _walk_block(b=512, s=20)
    res8, key8, _, _ = quantize_block_delta(big, n_anchors=8)
    q16b, _ = quantize_block(big, "int16")
    assert (res8.nbytes + key8.nbytes) / q16b.nbytes <= 0.6


def test_jax_delta_parity_and_cache():
    u = make_md_universe(n_residues=40, n_frames=32, step=0.05, seed=1)
    s = AlignedRMSF(u, select="name CA").run(backend="serial")
    cache = DeviceBlockCache()
    a = AlignedRMSF(u, select="name CA").run(
        backend="torch", batch_size=8, transfer_dtype="delta",
        block_cache=cache)
    err = float(np.abs(np.asarray(a.results.rmsf) - s.results.rmsf).max())
    assert err < 1e-3, f"delta RMSF err {err}"
    # second pass reads the staged residual blocks from the cache,
    # bit-identically
    misses = cache.misses
    b = AlignedRMSF(u, select="name CA").run(
        backend="torch", batch_size=8, transfer_dtype="delta",
        block_cache=cache)
    assert cache.misses == misses and cache.hits > 0
    np.testing.assert_array_equal(np.asarray(a.results.rmsf),
                                  np.asarray(b.results.rmsf))
    # a time-series analysis exercises the no-fold accumulation path
    ca = u.select_atoms("name CA")
    sr = RMSD(ca).run(backend="serial")
    ar = RMSD(ca).run(backend="torch", batch_size=8, transfer_dtype="delta")
    terr = float(np.abs(np.asarray(ar.results.rmsd) - sr.results.rmsd).max())
    assert terr < 1e-3, f"delta RMSD err {terr}"


def test_mesh_delta_parity_and_prestage():
    # the reference's 8 virtual devices: four shards on the CPU
    devices = ["cpu"] * 4
    u = make_md_universe(n_residues=40, n_frames=64, step=0.05, seed=2)
    s = AlignedRMSF(u, select="name CA").run(backend="serial")
    m = AlignedRMSF(u, select="name CA").run(
        backend=MeshExecutor(batch_size=4, devices=devices,
                             transfer_dtype="delta"))
    err = float(np.abs(np.asarray(m.results.rmsf) - s.results.rmsf).max())
    assert err < 1e-3, f"mesh delta RMSF err {err}"
    # decode-then-wire schedule produces the identical record
    p = AlignedRMSF(u, select="name CA").run(
        backend=MeshExecutor(batch_size=4, devices=devices,
                             transfer_dtype="delta", prestage=True))
    np.testing.assert_array_equal(np.asarray(m.results.rmsf),
                                  np.asarray(p.results.rmsf))


def test_delta_inv_abs_shards_with_anchors():
    """The (A, 1, 1) inv_abs is the multi-controller enabler: one
    locally-computed scale per anchor, sharded with the keyframes —
    never a replicated scalar that N processes would have to agree
    on."""
    block = _walk_block(b=32)
    res, key, inv_abs, inv_res = quantize_block_delta(block, n_anchors=4)
    assert inv_abs.shape == (4, 1, 1)
    assert key.shape[0] == 4
    # all anchors of ONE local block share the block's scale
    assert np.all(inv_abs == inv_abs[0, 0, 0])


def test_delta_rejected_for_ring_kernels():
    from mdanalysis_mpi_tpu_torch.analysis import InterRDF
    from mdanalysis_mpi_tpu_torch.testing import make_water_universe

    w = make_water_universe(n_waters=27, n_frames=4)
    ow = w.select_atoms("name OW")
    with pytest.raises(ValueError, match="float32"):
        InterRDF(ow, ow, nbins=8, range=(0.0, 5.0), engine="ring").run(
            backend=MeshExecutor(batch_size=2, transfer_dtype="delta"))


@pytest.mark.slow
def test_flagship_scale_delta_parity():
    """The done criterion at flagship ATOM count: 100k atoms, correlated
    trajectory, heavy-atom selection — oracle diff < 1e-3."""
    u = make_md_universe(n_residues=25_000, n_frames=96, step=0.05, seed=3)
    s = AlignedRMSF(u, select="heavy").run(backend="serial")
    a = AlignedRMSF(u, select="heavy").run(
        backend="torch", batch_size=32, transfer_dtype="delta")
    err = float(np.abs(np.asarray(a.results.rmsf) - s.results.rmsf).max())
    assert err < 1e-3, f"flagship-scale delta RMSF err {err}"


def test_quantize_block_delta_fuzz():
    """Property fuzz: for arbitrary finite blocks and anchor splits,
    reconstruction error stays within the per-frame closed-loop bound
    (keyframe step + that frame's residual step)."""
    hyp = pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=40, deadline=None)
    @given(
        b_seg=st.sampled_from([(4, 1), (8, 2), (12, 3), (16, 4)]),
        s=st.integers(min_value=1, max_value=9),
        scale=st.floats(min_value=1e-3, max_value=1e3),
        step=st.floats(min_value=1e-6, max_value=10.0),
        seed=st.integers(min_value=0, max_value=2**31 - 1),
    )
    def check(b_seg, s, scale, step, seed):
        b, n_anchors = b_seg
        rng = np.random.default_rng(seed)
        base = rng.normal(scale=scale, size=(s, 3))
        walk = np.cumsum(rng.normal(scale=step, size=(b, s, 3)), axis=0)
        block = (base[None] + walk).astype(np.float32)
        res, key, inv_abs, inv_res = quantize_block_delta(
            block, n_anchors=n_anchors)
        seg = b // n_anchors
        for a in range(n_anchors):
            sl = slice(a * seg, (a + 1) * seg)
            xhat = _reconstruct(res[sl], key[a:a + 1],
                                inv_abs[a:a + 1],
                                inv_res[sl])
            err = np.abs(xhat - block[sl]).max(axis=(1, 2))
            bound = (0.51 * (inv_res[sl, 0, 0]
                             + inv_abs[a, 0, 0]) + 1e-6)
            assert (err <= bound).all(), (err, bound)

    check()


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


@pytest.mark.parametrize("analysis", ["AlignedRMSF", "RMSD"])
def test_delta_run_matches_jax_package(analysis):
    """The delta wire end to end: the port's run against the JAX
    package's on the same correlated trajectory, within the reference
    case's 1e-3 Å."""
    def case(mod):
        u = mod("testing").make_md_universe(n_residues=20, n_frames=24,
                                            step=0.05, seed=2)
        cls = getattr(mod("analysis"), analysis)
        a = (cls(u, select="name CA") if analysis == "AlignedRMSF"
             else cls(u.select_atoms("name CA")))
        r = a.run(backend="jax" if mod().__name__ == "mdanalysis_mpi_tpu"
                  else "torch", batch_size=8, transfer_dtype="delta")
        return r.results.rmsf if analysis == "AlignedRMSF" \
            else r.results.rmsd
    ref, port = both(case)
    np.testing.assert_allclose(port, ref, atol=1e-3)
