"""Scan-folded dispatch in the port against the JAX package's
(tests/test_scan_fold.py, case for case).

A group of cached blocks is dispatched once: on a CUDA device as one
replayed CUDA graph (tests/test_torch_cuda.py holds that on the card),
here on the CPU as the same kernel sequence run eagerly.  Each group
folds its blocks into the running total one by one, in the per-block
schedule's order, so ``scan_k=K`` EQUALS ``scan_k=1`` (``torch.equal``)
for every single-device case; the mesh merges once per group, so its
scan runs are held to the serial oracle as the JAX suite holds its own.
Both packages get the same fixtures (the testing modules build the same
frames from a seed); the JAX package runs on ``JAX_PLATFORMS=cpu``.
"""

import os

import numpy as np
import pytest
import torch

import mdanalysis_mpi_tpu_torch.parallel.executors as ex
from mdanalysis_mpi_tpu import analysis as jax_analysis
from mdanalysis_mpi_tpu import testing as jax_testing
from mdanalysis_mpi_tpu.parallel.executors import (
    DeviceBlockCache as JaxCache, JaxExecutor)
from mdanalysis_mpi_tpu_torch.analysis import (RMSD, RMSF, AlignedRMSF,
                                               InterRDF)
from mdanalysis_mpi_tpu_torch.parallel.executors import (
    DeviceBlockCache, MeshExecutor, TorchExecutor, _resolve_scan_k,
    stage_analysis, warmup_analysis)
from mdanalysis_mpi_tpu_torch.testing import (make_md_universe,
                                              make_protein_universe,
                                              make_water_universe)
from mdanalysis_mpi_tpu_torch.utils import compile_cache
from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS

CPU = "cpu"
CPU8 = ["cpu"] * 8


def _rmsf_err(r, oracle):
    return float(np.abs(np.asarray(r.results.rmsf)
                        - np.asarray(oracle.results.rmsf)).max())


def _same(a, b, key) -> bool:
    """Bitwise equality of one result of two runs (a device tensor or,
    once read, its NumPy copy)."""
    x, y = (np.asarray(getattr(r.results, key)) for r in (a, b))
    return x.dtype == y.dtype and np.array_equal(x, y)


def _torch(**kw):
    return TorchExecutor(device=CPU, **kw)


# ---- resolution policy ----

def test_resolve_scan_k_policy(monkeypatch):
    monkeypatch.delenv("MDTPU_SCAN_K", raising=False)
    monkeypatch.delenv("MDTPU_SCAN_HBM_BUDGET", raising=False)
    cache = DeviceBlockCache(max_bytes=100)
    assert _resolve_scan_k(None, None, 10, 10) == 1
    assert _resolve_scan_k(4, None, 10, 10) == 1
    assert _resolve_scan_k("auto", cache, 10, 10) == 10
    assert _resolve_scan_k("auto", cache, 10, 30) == 3
    assert _resolve_scan_k(4, cache, 10, 10) == 4
    assert _resolve_scan_k(64, cache, 10, 10) == 10
    assert _resolve_scan_k(8, cache, 10, 30) == 3
    assert _resolve_scan_k(0, cache, 10, 10) == 1
    monkeypatch.setenv("MDTPU_SCAN_K", "3")
    assert _resolve_scan_k(None, cache, 10, 10) == 3
    monkeypatch.setenv("MDTPU_SCAN_K", "auto")
    monkeypatch.setenv("MDTPU_SCAN_HBM_BUDGET", "50")
    assert _resolve_scan_k(None, cache, 10, 10) == 5
    assert _resolve_scan_k("auto", cache, 0, 10) == 1
    # the JAX package resolves every case the same way
    from mdanalysis_mpi_tpu.parallel.executors import (
        _resolve_scan_k as jax_resolve)

    for args in ((None, 10, 10), (4, 10, 10), ("auto", 10, 30),
                 (8, 10, 30), (0, 10, 10)):
        jc = JaxCache(max_bytes=100)
        s, n, b = args
        assert (_resolve_scan_k(s, cache, n, b)
                == jax_resolve(s, jc, n, b))


# ---- single device: reduction parity, tails, dispatch counts ----

@pytest.fixture(scope="module")
def prot_u():
    # 52 frames / batch 8 → 7 blocks (last short): with scan_k=4 the
    # groups are 4 + 3 — K ∤ n_blocks AND a mask-padded final block
    return make_protein_universe(n_residues=16, n_frames=52, noise=0.2)


@pytest.fixture(scope="module")
def jax_prot_u():
    return jax_testing.make_protein_universe(n_residues=16, n_frames=52,
                                             noise=0.2)


@pytest.fixture(scope="module")
def prot_oracle(prot_u):
    return AlignedRMSF(prot_u, select="name CA").run(backend="serial")


def test_scan_parity_and_uneven_tail(prot_u, jax_prot_u, prot_oracle):
    cache = DeviceBlockCache()
    exe = _torch(batch_size=8, block_cache=cache, transfer_dtype="int16",
                 scan_k=4)
    prot_u.trajectory.__dict__.pop("_quant_max_hints", None)
    r1 = AlignedRMSF(prot_u, select="name CA").run(backend=exe)
    assert ex.LAST_SCAN_K == 4
    # the populating pass wrote GROUP entries (4-block and 3-block tail)
    assert sorted(key[-1] for key in cache._store) == [3, 4]
    r2 = AlignedRMSF(prot_u, select="name CA").run(backend=exe)
    assert _rmsf_err(r1, prot_oracle) < 1e-3
    assert _rmsf_err(r2, prot_oracle) < 1e-3
    prot_u.trajectory.__dict__.pop("_quant_max_hints", None)
    k1 = AlignedRMSF(prot_u, select="name CA").run(
        backend=_torch(batch_size=8, block_cache=DeviceBlockCache(),
                       transfer_dtype="int16", scan_k=1))
    for r in (r1, r2):
        assert _same(r, k1, "rmsf")
    j = jax_analysis.AlignedRMSF(jax_prot_u, select="name CA").run(
        backend=JaxExecutor(batch_size=8, block_cache=JaxCache(),
                            transfer_dtype="int16", scan_k=4))
    np.testing.assert_allclose(r1.results.rmsf, np.asarray(j.results.rmsf),
                               atol=5e-4)


def test_scan_dispatch_count_shrinks(prot_u, prot_oracle):
    """A steady K-grouped run costs ceil(n_blocks/K) dispatches per
    pass, not n_blocks."""
    cache = DeviceBlockCache()
    exe = _torch(batch_size=8, block_cache=cache, scan_k=4)
    AlignedRMSF(prot_u, select="name CA").run(backend=exe)   # populate
    c0 = TIMERS.calls("dispatch")
    r = AlignedRMSF(prot_u, select="name CA").run(backend=exe)
    # 7 blocks → groups of 4+3 → 2 dispatches per pass, 2 passes
    assert TIMERS.calls("dispatch") - c0 == 4
    assert _rmsf_err(r, prot_oracle) < 1e-3


def test_scan_k1_degenerates_bit_identically(prot_u):
    """scan_k=1 IS the per-block schedule: bitwise-equal results to a
    run with no cache at all, and per-block cache keys."""
    plain = AlignedRMSF(prot_u, select="name CA").run(
        backend="torch", device=CPU, batch_size=8, block_cache=None)
    cache = DeviceBlockCache()
    k1 = AlignedRMSF(prot_u, select="name CA").run(
        backend=_torch(batch_size=8, block_cache=cache, scan_k=1))
    assert ex.LAST_SCAN_K == 1
    assert all("scan" not in key for key in cache._store)
    assert _same(plain, k1, "rmsf")


def test_scan_auto_engages_with_cache(prot_u, prot_oracle, monkeypatch):
    monkeypatch.delenv("MDTPU_SCAN_K", raising=False)
    cache = DeviceBlockCache()
    r = AlignedRMSF(prot_u, select="name CA").run(
        backend="torch", device=CPU, batch_size=8, block_cache=cache)
    # tiny blocks, 4 GiB budget → auto folds all 7 blocks into one group
    assert ex.LAST_SCAN_K == 7
    assert _rmsf_err(r, prot_oracle) < 1e-3
    monkeypatch.setenv("MDTPU_SCAN_K", "2")
    r2 = AlignedRMSF(prot_u, select="name CA").run(
        backend="torch", device=CPU, batch_size=8,
        block_cache=DeviceBlockCache())
    assert ex.LAST_SCAN_K == 2
    assert _rmsf_err(r2, prot_oracle) < 1e-3


@pytest.mark.parametrize("dtype", ["int16", "int8", "delta", "float32"])
@pytest.mark.parametrize("engine", [None, "fused"])
def test_scan_auto_equals_per_block(dtype, engine):
    """``scan_k='auto'`` equals ``scan_k=1`` (``torch.equal``) for
    AlignedRMSF in every staging dtype and both engines: the populating
    run (pass 2 folded) and the repeat (both passes folded)."""
    u = make_protein_universe(n_residues=300, n_frames=60, noise=0.3,
                              seed=4)

    def run(scan_k, cache):
        u.trajectory.__dict__.pop("_quant_max_hints", None)
        return AlignedRMSF(u, select="name CA", engine=engine).run(
            backend="torch", device=CPU, batch_size=16,
            transfer_dtype=dtype, block_cache=cache, scan_k=scan_k)

    ref = run(1, DeviceBlockCache())
    cache = DeviceBlockCache()
    for r in (run("auto", cache), run("auto", cache)):
        assert _same(r, ref, "rmsf")
        assert _same(r, ref, "m2")


def test_scan_series_rmsd(prot_u, jax_prot_u):
    ca = prot_u.select_atoms("name CA")
    s = RMSD(ca).run(backend="serial")
    k1 = RMSD(ca).run(backend=_torch(batch_size=8, scan_k=1,
                                     block_cache=DeviceBlockCache()))
    cache = DeviceBlockCache()
    exe = _torch(batch_size=8, block_cache=cache, scan_k=4)
    r1 = RMSD(ca).run(backend=exe)
    r2 = RMSD(ca).run(backend=exe)      # the group-hit path
    for r in (r1, r2):
        assert r.results.rmsd.shape == s.results.rmsd.shape
        assert np.abs(r.results.rmsd - s.results.rmsd).max() < 1e-3
        assert _same(r, k1, "rmsd")
    j = jax_analysis.RMSD(jax_prot_u.select_atoms("name CA")).run(
        backend=JaxExecutor(batch_size=8, block_cache=JaxCache(), scan_k=4))
    np.testing.assert_allclose(r2.results.rmsd, np.asarray(j.results.rmsd),
                               atol=1e-5)


def test_scan_delta_staging():
    # delta's precision envelope needs the correlated MD fixture
    u = make_md_universe(n_residues=10, n_frames=48, seed=7)
    s = AlignedRMSF(u, select="name CA").run(backend="serial")
    cache = DeviceBlockCache()
    exe = _torch(batch_size=8, block_cache=cache, transfer_dtype="delta",
                 scan_k=3)
    r1 = AlignedRMSF(u, select="name CA").run(backend=exe)
    r2 = AlignedRMSF(u, select="name CA").run(backend=exe)
    assert _rmsf_err(r1, s) < 1e-3
    assert _rmsf_err(r2, s) < 1e-3
    assert _same(r1, r2, "rmsf")


def test_scan_rdf_equals_per_block():
    """A cached InterRDF repeat: the folded counts EQUAL the per-block
    ones, and the JAX package's."""
    w = make_water_universe(n_waters=24, n_frames=32)
    ow = w.select_atoms("name OW")
    kw = dict(nbins=16, range=(0.0, 6.0))

    def run(scan_k, cache):
        return InterRDF(ow, ow, **kw).run(backend="torch", device=CPU,
                                          batch_size=4, block_cache=cache,
                                          scan_k=scan_k)

    ref = run(1, DeviceBlockCache())
    cache = DeviceBlockCache()
    for g in (run("auto", cache), run("auto", cache)):
        np.testing.assert_array_equal(g.results.count, ref.results.count)
        np.testing.assert_array_equal(g.results.rdf, ref.results.rdf)
    jw = jax_testing.make_water_universe(n_waters=24, n_frames=32)
    jow = jw.select_atoms("name OW")
    j = jax_analysis.InterRDF(jow, jow, **kw).run(
        backend=JaxExecutor(batch_size=4, block_cache=JaxCache(), scan_k=8))
    np.testing.assert_array_equal(ref.results.count,
                                  np.asarray(j.results.count))


# ---- mesh: agreement, one merge per group ----

def test_scan_mesh_agreement_reduction_and_series():
    u = make_protein_universe(n_residues=12, n_frames=56, noise=0.2)
    s = AlignedRMSF(u, select="name CA").run(backend="serial")
    cache = DeviceBlockCache()
    m = MeshExecutor(batch_size=2, devices=CPU8, block_cache=cache,
                     transfer_dtype="int16", scan_k=3)
    r1 = AlignedRMSF(u, select="name CA").run(backend=m)
    # 56 frames / global batch 16 → 4 blocks → scan groups 3 + 1
    assert sorted(key[-1] for key in cache._store) == [1, 3]
    r2 = AlignedRMSF(u, select="name CA").run(backend=m)
    assert _rmsf_err(r1, s) < 1e-3
    assert _rmsf_err(r2, s) < 1e-3

    ca = u.select_atoms("name CA")
    sr = RMSD(ca).run(backend="serial")
    ms = MeshExecutor(batch_size=2, devices=CPU8,
                      block_cache=DeviceBlockCache(), scan_k=2)
    a1 = RMSD(ca).run(backend=ms)
    a2 = RMSD(ca).run(backend=ms)
    for a in (a1, a2):
        assert np.abs(a.results.rmsd - sr.results.rmsd).max() < 1e-3
    # a series concatenates in frame order: the folded mesh equals the
    # per-block mesh exactly
    k1 = RMSD(ca).run(backend=MeshExecutor(batch_size=2, devices=CPU8,
                                           scan_k=1))
    assert _same(a2, k1, "rmsd")


def test_scan_mesh_one_merge_per_scan(monkeypatch):
    """The mesh folds LOCAL partials across the group on each device
    and merges ONCE: a steady K=4 run calls ``_device_combine`` once a
    pass where the per-block schedule calls it once a block."""
    calls = []
    real = RMSF._device_combine

    def counting(parts, comm=None):
        calls.append(len(parts))
        return real(parts, comm)

    monkeypatch.setattr(RMSF, "_device_combine", staticmethod(counting))
    u = make_protein_universe(n_residues=8, n_frames=64, noise=0.2)
    ag = u.select_atoms("name CA")
    s = RMSF(ag).run(backend="serial")
    m = MeshExecutor(batch_size=2, devices=CPU8,
                     block_cache=DeviceBlockCache(), scan_k=4)
    RMSF(ag).run(backend=m)              # populate: 4 blocks, 4 merges
    assert calls == [8] * 4
    del calls[:]
    r = RMSF(ag).run(backend=m)          # one group: one merge
    assert calls == [8]
    np.testing.assert_allclose(r.results.rmsf, s.results.rmsf, atol=1e-4)


def test_scan_mesh_rdf():
    w = make_water_universe(n_waters=24, n_frames=32)
    ow = w.select_atoms("name OW")
    s = InterRDF(ow, ow, nbins=16, range=(0.0, 6.0)).run(backend="serial")
    cache = DeviceBlockCache()
    m = MeshExecutor(batch_size=2, devices=CPU8, block_cache=cache,
                     scan_k=2)
    g1 = InterRDF(ow, ow, nbins=16, range=(0.0, 6.0)).run(backend=m)
    g2 = InterRDF(ow, ow, nbins=16, range=(0.0, 6.0)).run(backend=m)
    for g in (g1, g2):
        assert np.abs(np.asarray(g.results.rdf)
                      - s.results.rdf).max() < 1e-3
    np.testing.assert_array_equal(g1.results.count, g2.results.count)


def test_scan_prestage_chunk_barrier(prot_u, prot_oracle, monkeypatch):
    """Cold prestage run with a scan group completing ON a chunk's last
    wired block: the chunk barrier reads none of the group's released
    per-block tensors, and the result equals the interleaved run."""
    monkeypatch.setenv("MDTPU_PRESTAGE_CHUNK", "2")
    monkeypatch.setenv("MDTPU_WIRE_WINDOW", "2")
    exe = _torch(batch_size=8, block_cache=DeviceBlockCache(), scan_k=2,
                 prestage=True)
    r1 = AlignedRMSF(prot_u, select="name CA").run(backend=exe)
    r2 = AlignedRMSF(prot_u, select="name CA").run(backend=exe)
    assert _rmsf_err(r1, prot_oracle) < 1e-3
    assert _rmsf_err(r2, prot_oracle) < 1e-3
    plain = AlignedRMSF(prot_u, select="name CA").run(
        backend=_torch(batch_size=8, block_cache=DeviceBlockCache(),
                       scan_k=2))
    assert _same(r2, plain, "rmsf")


# ---- checkpoint composition ----

def test_checkpoint_resume_composes_with_scan(tmp_path):
    """Crash mid-run under the scan schedule, resume, match the
    uninterrupted result: checkpoints land between executor calls, so a
    scan group never spans one."""
    import mdanalysis_mpi_tpu_torch.utils.checkpoint as ckpt_mod
    from mdanalysis_mpi_tpu_torch.utils.checkpoint import run_checkpointed

    u = make_protein_universe(n_residues=12, n_frames=48, noise=0.2)
    ag = u.select_atoms("name CA")
    straight = RMSF(ag).run(backend="serial")
    exe = _torch(batch_size=4, block_cache=DeviceBlockCache(), scan_k=2)
    ck = str(tmp_path / "scan.ckpt.npz")
    real_save = ckpt_mod._save
    calls = {"n": 0}

    def crashing_save(p, done, partials, fp, dropped=()):
        real_save(p, done, partials, fp, dropped)
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("simulated crash")

    ckpt_mod._save = crashing_save
    try:
        with pytest.raises(RuntimeError):
            run_checkpointed(RMSF(ag), ck, chunk_frames=16, backend=exe)
    finally:
        ckpt_mod._save = real_save
    assert os.path.exists(ck)
    a2 = RMSF(ag)
    run_checkpointed(a2, ck, chunk_frames=16, backend=exe)
    assert not os.path.exists(ck)
    assert np.abs(np.asarray(a2.results.rmsf)
                  - straight.results.rmsf).max() < 1e-3


def test_aligned_rmsf_checkpoint_multipass(tmp_path):
    """The two passes checkpoint end to end: a crash in pass 1 resumes;
    a crash in pass 2 resumes WITHOUT redoing pass 1 (its completed
    summary file survives); all files go on success; scan folding on
    throughout."""
    import mdanalysis_mpi_tpu_torch.utils.checkpoint as ckpt_mod
    from mdanalysis_mpi_tpu_torch.utils.checkpoint import run_checkpointed

    u = make_protein_universe(n_residues=12, n_frames=32, noise=0.2)
    s = AlignedRMSF(u, select="name CA").run(backend="serial")
    td = str(tmp_path)
    kw = dict(chunk_frames=8, backend="torch", device=CPU, batch_size=4,
              checkpoint_dir=td, scan_k=2)

    a = AlignedRMSF(u, select="name CA")
    run_checkpointed(a, **kw)
    assert _rmsf_err(a, s) < 1e-3
    assert not os.listdir(td)

    real_save = ckpt_mod._save
    calls = {"n": 0}

    def crash_at(n):
        def crashing_save(p, done, partials, fp, dropped=()):
            real_save(p, done, partials, fp, dropped)
            calls["n"] += 1
            if calls["n"] == n:
                raise RuntimeError("simulated crash")
        return crashing_save

    for n_crash, n_files in ((1, 1), (6, 2)):
        calls["n"] = 0
        ckpt_mod._save = crash_at(n_crash)
        try:
            with pytest.raises(RuntimeError):
                run_checkpointed(AlignedRMSF(u, select="name CA"), **kw)
        finally:
            ckpt_mod._save = real_save
        assert len(os.listdir(td)) == n_files
        a2 = AlignedRMSF(u, select="name CA")
        run_checkpointed(a2, **kw)
        assert _rmsf_err(a2, s) < 1e-3
        assert _same(a2, a, "rmsf")
        assert not os.listdir(td)


# ---- the cache's release rules ----

def test_device_cache_overwrite_deletes_old_tensors():
    cache = DeviceBlockCache()
    old = (torch.zeros(8), torch.ones(8))
    cache.put("k", old, 64)
    new = (torch.zeros(8), torch.ones(8))
    cache.put("k", new, 64)
    assert all(ex._is_deleted(t) for t in old)
    assert not any(ex._is_deleted(t) for t in new)
    # an overwrite credits the replaced bytes back
    assert cache._bytes == 64
    assert not cache.full
    cache.drop()
    assert all(ex._is_deleted(t) for t in new)
    assert len(cache._store) == 0
    assert cache._bytes == 0


def test_device_cache_overwrite_byte_accounting_near_cap():
    cache = DeviceBlockCache(max_bytes=100)
    a = (torch.zeros(8),)
    cache.put("k", a, 60)
    b = (torch.zeros(8),)
    cache.put("k", b, 80)
    assert cache._bytes == 80 and not cache.full
    assert all(ex._is_deleted(t) for t in a)
    # a genuinely-too-big overwrite is rejected; the old entry survives
    c = (torch.zeros(8),)
    cache.put("k", c, 200)
    assert cache.get("k") is b
    assert not any(ex._is_deleted(t) for t in b)
    assert cache.full


def test_device_cache_removal_paths_drop_programs():
    """Every path that removes an entry drops the programs kept with it
    (on the card, the group's captured graph), and a program is handed
    out only for the very value it was kept with."""
    cache = DeviceBlockCache()
    ent = {k: (torch.zeros(4),) for k in ("a", "b", "c")}
    for k, v in ent.items():
        cache.put(("ns", k), v, 16)
        assert cache.put_program(("ns", k), v, "tag", object())
    assert sum(map(len, cache._programs.values())) == 3
    assert cache.program(("ns", "a"), (torch.zeros(4),), "tag") is None
    assert not cache.put_program(("ns", "a"), (torch.zeros(4),), "t2", 1)
    assert cache.quarantine(("ns", "a"), ent["a"])
    assert sum(map(len, cache._programs.values())) == 2
    cache.pin("other")
    cache.evict_unpinned()
    assert sum(map(len, cache._programs.values())) == 0 and not cache._store
    cache.put(("ns", "d"), (torch.zeros(4),), 16)
    cache.put_program(("ns", "d"), cache._store[("ns", "d")], "tag", 1)
    cache.clear()
    assert sum(map(len, cache._programs.values())) == 0


def test_scan_group_releases_per_block_tensors(prot_u, monkeypatch):
    """Stacking a missed group releases the K per-block staged tuples
    it consumed."""
    deleted = []
    real = ex._delete_staged
    monkeypatch.setattr(ex, "_delete_staged",
                        lambda staged: (deleted.append(staged),
                                        real(staged)))
    cache = DeviceBlockCache()
    RMSF(prot_u.select_atoms("name CA")).run(
        backend=_torch(batch_size=8, block_cache=cache, scan_k=4))
    # 7 blocks in 2 groups: every per-block tuple released, none of the
    # 2 cached stacked groups
    assert len(deleted) == 7
    assert len(cache._store) == 2


def test_scrub_quarantines_a_corrupted_group(prot_u):
    """Stage-time fingerprints chain over a group's blocks; a bit
    flipped in a cached group afterwards is caught by ``scrub`` and the
    entry (and its programs) leave the cache."""
    cache = DeviceBlockCache()
    ag = prot_u.select_atoms("name CA")
    exe = _torch(batch_size=8, block_cache=cache, scan_k=4,
                 transfer_dtype="int16")
    RMSF(ag).run(backend=exe)
    assert cache.scrub() == {"checked": 2, "corrupt": 0,
                             "bytes": cache.scrub()["bytes"],
                             "fetch_errors": 0}
    key = sorted(cache._store, key=lambda k: k[-1])[-1]
    cache._store[key][0].view(-1)[5] += 1
    out = cache.scrub()
    assert out["checked"] == 2 and out["corrupt"] == 1
    assert key not in cache._store
    r = RMSF(ag).run(backend=exe)          # re-stages the dropped group
    assert np.isfinite(r.results.rmsf).all()
    assert len(cache._store) == 2


# ---- warmup and staging ahead of time ----

def test_warmup_runs_every_dispatch_shape_once(prot_u, prot_oracle):
    """``warmup_analysis`` runs every program the run dispatches (the
    kernel, the fold, each scan group length of both passes) once on
    zero blocks, counted as warmed; the run after it gives the result
    of a run without one.  (What it builds on the card, the kernel
    library, is held in a fresh process by the ``cuda`` test
    ``test_cuda_warmup_then_run_builds_nothing_in_a_fresh_process``.)"""
    exe = _torch(batch_size=8, block_cache=DeviceBlockCache(), scan_k=4,
                 transfer_dtype="int16")
    a = AlignedRMSF(prot_u, select="name CA", engine="fused")
    prot_u.trajectory.__dict__.pop("_quant_max_hints", None)
    cold = AlignedRMSF(prot_u, select="name CA", engine="fused").run(
        backend=_torch(batch_size=8, block_cache=DeviceBlockCache(),
                       scan_k=4, transfer_dtype="int16"))
    c0 = compile_cache.counters()
    n = warmup_analysis(a, exe)
    # per pass: kernel, fold, scan_init(4) and scan_fused(3)
    assert n == 8
    assert compile_cache.counters()["warmed"] - c0["warmed"] == n
    prot_u.trajectory.__dict__.pop("_quant_max_hints", None)
    r = a.run(backend=exe)
    assert torch.equal(torch.as_tensor(r.results.rmsf),
                       torch.as_tensor(cold.results.rmsf))
    assert _rmsf_err(r, prot_oracle) < 1e-3
    j = jax_analysis.AlignedRMSF(
        jax_testing.make_protein_universe(n_residues=16, n_frames=52,
                                          noise=0.2), select="name CA")
    from mdanalysis_mpi_tpu.parallel.executors import (
        warmup_analysis as jax_warmup)

    assert jax_warmup(j, JaxExecutor(batch_size=8, block_cache=JaxCache(),
                                     scan_k=4)) == n


def test_stage_then_run_is_all_hits(prot_u):
    """``stage_analysis`` fills the cache on the exact schedule a run
    walks (same keys, same grouping) without dispatching; the run after
    it misses nothing."""
    cache = DeviceBlockCache()
    exe = _torch(batch_size=8, block_cache=cache, scan_k=4)
    ag = prot_u.select_atoms("name CA")
    c0 = TIMERS.calls("dispatch")
    assert stage_analysis(RMSF(ag), exe) == 7
    assert TIMERS.calls("dispatch") == c0
    m0 = cache.misses
    r = RMSF(ag).run(backend=exe)
    assert cache.misses == m0
    np.testing.assert_allclose(
        r.results.rmsf, RMSF(ag).run(backend="serial").results.rmsf,
        atol=1e-4)


# ---- op-level carry+step forms ----

def test_ops_scan_forms_match_sequential():
    import jax.numpy as jnp

    from mdanalysis_mpi_tpu.ops import align as jalign
    from mdanalysis_mpi_tpu.ops import rmsd as jrmsd
    from mdanalysis_mpi_tpu_torch.ops.align import scan_aligned_moments
    from mdanalysis_mpi_tpu_torch.ops.moments import (batch_moments,
                                                      reduce_moments,
                                                      scan_moments)
    from mdanalysis_mpi_tpu_torch.ops.rmsd import (rmsd_batch,
                                                   scan_rmsd_batch)

    rng = np.random.default_rng(3)
    blocks_np = rng.normal(size=(3, 4, 10, 3)).astype(np.float32)
    masks_np = np.array([[1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 0, 0]],
                        np.float32)
    blocks, masks = torch.from_numpy(blocks_np), torch.from_numpy(masks_np)
    t, mu, m2 = scan_moments(blocks, masks)
    rt, rmu, rm2 = reduce_moments(
        [batch_moments(blocks[i], masks[i]) for i in range(3)])
    assert float(t) == float(rt) == 10.0
    assert torch.equal(mu, rmu) and torch.equal(m2, rm2)

    w = torch.ones(10)
    ref = blocks[0, 0] - blocks[0, 0].mean(0)
    com = torch.zeros(3)
    t2, mu2, m2a = scan_aligned_moments(blocks, masks, w, ref, com)
    jt, jmu, jm2 = jalign.scan_aligned_moments(
        jnp.asarray(blocks_np), jnp.asarray(masks_np), jnp.ones(10),
        jnp.asarray(ref.numpy()), jnp.zeros(3))
    assert float(t2) == float(jt) == 10.0
    np.testing.assert_allclose(mu2.numpy(), np.asarray(jmu), atol=1e-5)
    np.testing.assert_allclose(m2a.numpy(), np.asarray(jm2), atol=1e-4)

    vals = scan_rmsd_batch(blocks, w, ref)
    seq = torch.cat([rmsd_batch(blocks[i], w, ref) for i in range(3)])
    assert torch.equal(vals, seq)
    jvals = jrmsd.scan_rmsd_batch(jnp.asarray(blocks_np), jnp.ones(10),
                                  jnp.asarray(ref.numpy()))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), atol=1e-5)


def test_run_report_discloses_this_runs_scan_k(prot_u):
    """The run report's ``scan_k`` is the one this run resolved (the
    JAX package's ``LAST_SCAN_K`` telemetry), 1 where the run had no
    scan schedule, beside the dispatch count the fold shrinks."""
    ag = prot_u.select_atoms("name CA")
    exe = _torch(batch_size=8, block_cache=DeviceBlockCache(), scan_k=4)
    rep = RMSF(ag).run_streaming(window=52, backend=exe
                                 ).results.observability
    # the populating run: the scan schedule, every block staged
    assert rep["scan_k"] == 4 and rep["dispatch_count"] == 7
    rep = RMSF(ag).run_streaming(window=52, backend=exe
                                 ).results.observability
    assert rep["scan_k"] == 4 and rep["dispatch_count"] == 2
    # a run without a cache resolves 1, whatever ran before it
    rep = RMSF(ag).run_streaming(window=52, device=CPU, batch_size=8
                                 ).results.observability
    assert rep["scan_k"] == 1 and rep["dispatch_count"] == 7
