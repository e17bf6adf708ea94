"""The port's resilient runs against the JAX package's
(tests/test_reliability.py, case for case, on the same fault schedules):
fault injection, retry/backoff/deadline, corrupt-frame salvage, the
Mesh → Torch → Serial degradation chain and crash-then-resume.

Both packages run the same fixture (the testing modules build the same
frames from a seed) under the same :class:`FaultSpec` schedules, each
through its own ``reliability.faults`` registry; the port runs on
``device="cpu"`` (the fused kernel's plain version), the JAX package on
``JAX_PLATFORMS=cpu``.  Cases of the JAX suite whose analyses the port
does not have yet (PCA, AnalysisFromFunction; ROADMAP A8) are left out.
"""

import glob
import os

import numpy as np
import pytest
import torch

from mdanalysis_mpi_tpu import analysis as jax_analysis
from mdanalysis_mpi_tpu import testing as jax_testing
from mdanalysis_mpi_tpu.reliability import faults as jax_faults
from mdanalysis_mpi_tpu.reliability.policy import (
    ReliabilityPolicy as JaxPolicy)
from mdanalysis_mpi_tpu_torch import _build
from mdanalysis_mpi_tpu_torch.analysis import (RMSD, RMSF, AlignedRMSF,
                                               AlignTraj, InterRDF)
from mdanalysis_mpi_tpu_torch.io.base import BlockCache
from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp
from mdanalysis_mpi_tpu_torch.parallel.executors import (DeviceBlockCache,
                                                         MeshExecutor,
                                                         TorchExecutor)
from mdanalysis_mpi_tpu_torch.reliability import faults
from mdanalysis_mpi_tpu_torch.reliability.faults import (
    DeviceLossError, FaultSpec, InjectedCrash, InjectedTransientError)
from mdanalysis_mpi_tpu_torch.reliability.policy import (
    CorruptFrameError, FallbackChain, ReliabilityPolicy, ReliabilityRuntime,
    degradation_chain, is_degradable)
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

pytestmark = pytest.mark.reliability

N_FRAMES = 24
TORCH = dict(backend="torch", device="cpu")
MESH = dict(backend="mesh", devices=["cpu"] * 4)


@pytest.fixture(scope="module")
def uni():
    return make_protein_universe(n_residues=8, n_frames=N_FRAMES,
                                 noise=0.25, seed=3)


@pytest.fixture(scope="module")
def oracle_rmsf(uni):
    return RMSF(uni.select_atoms("name CA")).run(
        backend="serial").results.rmsf


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    yield
    faults.clear()
    jax_faults.clear()


def fast_policy(**kw):
    kw.setdefault("backoff_s", 0.001)
    kw.setdefault("checkpoint", False)
    return ReliabilityPolicy(**kw)


# ---------------- fault registry semantics ----------------

class TestFaultInjection:
    def test_unfaulted_sites_cost_nothing(self, uni, oracle_rmsf):
        r = RMSF(uni.select_atoms("name CA")).run(
            batch_size=8, **TORCH).results.rmsf
        np.testing.assert_allclose(r, oracle_rmsf, atol=1e-3)

    def test_injection_without_policy_is_fatal(self, uni):
        with faults.inject(FaultSpec("kernel", "raise", times=None)):
            with pytest.raises(DeviceLossError):
                RMSF(uni.select_atoms("name CA")).run(batch_size=8,
                                                      **TORCH)

    def test_kernel_site_fires_once_per_group_dispatch(self, uni):
        """docs/DISPATCH.md: the ``kernel`` site fires once per
        dispatch — a block on the per-block schedule, a whole cached
        group on the folded one."""
        ag = uni.select_atoms("name CA")
        exe = TorchExecutor(batch_size=4, device="cpu", scan_k=3,
                            block_cache=DeviceBlockCache())
        counter = FaultSpec("kernel", "raise", times=0)
        with faults.inject(counter):
            RMSF(ag).run(backend=exe)        # 6 blocks staged: 6 visits
            assert counter.visits == 6
            RMSF(ag).run(backend=exe)        # 2 cached groups of 3
            assert counter.visits == 8


# ---------------- BlockCache over-cap fallback ----------------

class TestBlockCacheFull:
    def test_rejected_insert_flips_full(self):
        cache = BlockCache(max_bytes=100)
        cache.put("a", 1, 60)
        assert not cache.full
        cache.put("b", 2, 60)
        assert cache.get("b") is None
        assert cache.full
        cache.clear()
        assert not cache.full

    def test_exact_fit_still_reports_full(self):
        cache = BlockCache(max_bytes=100)
        cache.put("a", 1, 100)
        assert cache.full

    def test_over_cap_trajectory_still_correct(self, uni):
        cache = DeviceBlockCache(max_bytes=1)     # everything over-cap
        r = AlignedRMSF(uni, select="name CA").run(
            batch_size=8, block_cache=cache, **TORCH)
        assert cache.full
        ref = AlignedRMSF(uni, select="name CA").run(
            backend="serial").results.rmsf
        np.testing.assert_allclose(r.results.rmsf, ref,
                                   rtol=5e-3, atol=1e-3)


# ---------------- corrupt-frame policy ----------------

def _persistent_corruption(frame, mod=faults):
    return (mod.FaultSpec("stage", "corrupt", frames=[frame], times=None),
            mod.FaultSpec("read", "corrupt", frames=[frame], times=None))


class TestCorruptFrames:
    def test_skip_with_count_batch(self, uni):
        with faults.inject(*_persistent_corruption(5)):
            r = RMSF(uni.select_atoms("name CA")).run(
                resilient=fast_policy(), batch_size=8, **TORCH)
        assert list(r.results.reliability["dropped_frames"]) == [5]
        ref = RMSF(uni.select_atoms("name CA")).run(
            frames=[i for i in range(N_FRAMES) if i != 5],
            backend="serial").results.rmsf
        np.testing.assert_allclose(r.results.rmsf, ref, atol=1e-3)

    def test_transient_corruption_heals_by_reread(self, uni, oracle_rmsf):
        with faults.inject(FaultSpec("stage", "corrupt", frames=[3],
                                     times=1)):
            r = RMSF(uni.select_atoms("name CA")).run(
                resilient=fast_policy(), batch_size=8, **TORCH)
        rel = r.results.reliability
        assert list(rel["healed_frames"]) == [3]
        assert len(rel["dropped_frames"]) == 0
        np.testing.assert_allclose(r.results.rmsf, oracle_rmsf, atol=1e-3)

    def test_abort_policy(self, uni):
        with faults.inject(*_persistent_corruption(5)):
            with pytest.raises(CorruptFrameError):
                RMSF(uni.select_atoms("name CA")).run(
                    resilient=fast_policy(on_corrupt="abort"),
                    batch_size=8, **TORCH)

    def test_drop_budget_aborts(self, uni):
        specs = _persistent_corruption(2) + _persistent_corruption(3)
        with faults.inject(*specs):
            with pytest.raises(CorruptFrameError):
                RMSF(uni.select_atoms("name CA")).run(
                    resilient=fast_policy(max_dropped_frames=1),
                    batch_size=8, **TORCH)

    def test_garbage_coordinates_detected(self, uni):
        specs = (FaultSpec("stage", "corrupt", frames=[4], times=None,
                           corrupt="garbage"),
                 FaultSpec("read", "corrupt", frames=[4], times=None,
                           corrupt="garbage"))
        with faults.inject(*specs):
            r = RMSF(uni.select_atoms("name CA")).run(
                resilient=fast_policy(), batch_size=8, **TORCH)
        assert list(r.results.reliability["dropped_frames"]) == [4]

    def test_batched_series_refuses_silent_skip(self, uni):
        with faults.inject(*_persistent_corruption(5)):
            with pytest.raises(CorruptFrameError, match="serial"):
                RMSD(uni.select_atoms("name CA")).run(
                    resilient=fast_policy(), batch_size=8, **TORCH)

    def test_repeat_drop_charges_budget_once(self):
        rt = ReliabilityRuntime(fast_policy(max_dropped_frames=1))
        rt._record_drop(5)
        rt._record_drop(5)
        assert rt.report.dropped_frames == [5]
        with pytest.raises(CorruptFrameError):
            rt._record_drop(6)

    def test_shared_cache_does_not_blind_second_run(self, uni):
        cache = DeviceBlockCache()
        reports = []
        for _ in range(2):
            with faults.inject(*_persistent_corruption(5)):
                r = RMSF(uni.select_atoms("name CA")).run(
                    resilient=fast_policy(), batch_size=8,
                    block_cache=cache, **TORCH)
            reports.append(list(r.results.reliability["dropped_frames"]))
        assert reports == [[5], [5]]

    def test_serial_skip_and_truncated_frame(self, uni):
        specs = (FaultSpec("read", "corrupt", frames=[7], times=None),
                 FaultSpec("read", "corrupt", frames=[9], times=None,
                           corrupt="truncate"))
        with faults.inject(*specs):
            r = RMSF(uni.select_atoms("name CA")).run(
                resilient=fast_policy(), backend="serial")
        assert list(r.results.reliability["dropped_frames"]) == [7, 9]
        ref = RMSF(uni.select_atoms("name CA")).run(
            frames=[i for i in range(N_FRAMES) if i not in (7, 9)],
            backend="serial").results.rmsf
        np.testing.assert_allclose(r.results.rmsf, ref, atol=1e-6)


# ---------------- retry / backoff / deadline ----------------

class TestRetryPolicy:
    def test_staging_retry_with_backoff(self, uni, oracle_rmsf):
        with faults.inject(FaultSpec("stage", "raise", times=2)):
            r = RMSF(uni.select_atoms("name CA")).run(
                resilient=fast_policy(), batch_size=8, **TORCH)
        assert r.results.reliability["retries"]["stage"] == 2
        np.testing.assert_allclose(r.results.rmsf, oracle_rmsf, atol=1e-3)

    def test_transfer_retry(self, uni, oracle_rmsf):
        with faults.inject(FaultSpec("put", "raise", times=1)):
            r = RMSF(uni.select_atoms("name CA")).run(
                resilient=fast_policy(), batch_size=8, **TORCH)
        assert r.results.reliability["retries"]["put"] == 1
        np.testing.assert_allclose(r.results.rmsf, oracle_rmsf, atol=1e-3)

    def test_stall_past_deadline_retried(self, uni, oracle_rmsf):
        with faults.inject(FaultSpec("stage", "stall", stall_s=0.06,
                                     times=1)):
            r = RMSF(uni.select_atoms("name CA")).run(
                resilient=fast_policy(stage_deadline_s=0.02),
                batch_size=8, **TORCH)
        assert r.results.reliability["deadline_misses"] == 1
        np.testing.assert_allclose(r.results.rmsf, oracle_rmsf, atol=1e-3)

    def test_retry_budget_exhaustion_raises(self, uni):
        with faults.inject(FaultSpec("stage", "raise", times=None)):
            with pytest.raises(InjectedTransientError):
                RMSF(uni.select_atoms("name CA")).run(
                    resilient=fast_policy(fallback=False),
                    batch_size=8, **TORCH)

    def test_programming_errors_not_retried(self):
        rt = ReliabilityRuntime(fast_policy())
        calls = []

        def boom():
            calls.append(1)
            raise ValueError("not transient")

        with pytest.raises(ValueError):
            rt.op("stage", boom)
        assert len(calls) == 1

    def test_deterministic_oserror_not_retried(self):
        rt = ReliabilityRuntime(fast_policy())
        calls = []

        def missing():
            calls.append(1)
            raise FileNotFoundError("/no/such/trajectory.xtc")

        with pytest.raises(FileNotFoundError):
            rt.op("stage", missing)
        assert len(calls) == 1


# ---------------- graceful degradation ----------------

class TestFallback:
    def test_persistent_device_loss_completes_via_chain(self, uni,
                                                        oracle_rmsf):
        with faults.inject(FaultSpec("kernel", "raise", times=None)):
            r = RMSF(uni.select_atoms("name CA")).run(
                resilient=fast_policy(), batch_size=4, **MESH)
        np.testing.assert_allclose(r.results.rmsf, oracle_rmsf, atol=1e-6)
        hops = [(f, t) for f, t, _ in r.results.reliability["fallbacks"]]
        assert hops == [("mesh", "torch"), ("torch", "serial")]

    def test_series_analysis_falls_back_to_serial(self, uni):
        ref = RMSD(uni.select_atoms("name CA")).run(
            backend="serial").results.rmsd
        with faults.inject(FaultSpec("kernel", "raise", times=None)):
            r = RMSD(uni.select_atoms("name CA")).run(
                resilient=fast_policy(), batch_size=8, **TORCH)
        np.testing.assert_allclose(r.results.rmsd, ref, atol=1e-6)
        assert [(f, t) for f, t, _ in
                r.results.reliability["fallbacks"]] == [("torch", "serial")]

    def test_fallback_disabled_raises(self, uni):
        with faults.inject(FaultSpec("kernel", "raise", times=None)):
            with pytest.raises(DeviceLossError):
                RMSF(uni.select_atoms("name CA")).run(
                    resilient=fast_policy(fallback=False),
                    batch_size=8, **TORCH)

    def test_non_degradable_errors_propagate(self, uni):
        with faults.inject(FaultSpec("kernel", "raise", times=None,
                                     exc=InjectedCrash)):
            with pytest.raises(InjectedCrash):
                RMSF(uni.select_atoms("name CA")).run(
                    resilient=fast_policy(), batch_size=8, **TORCH)

    def test_classification(self):
        """Explicit types, not message text (the JAX package keys on
        the names of XLA's runtime errors)."""
        assert is_degradable(DeviceLossError("DEVICE_LOST"))
        assert is_degradable(torch.cuda.OutOfMemoryError("out of memory"))
        accel = getattr(torch, "AcceleratorError", None)
        if isinstance(accel, type):
            assert is_degradable(accel.__new__(accel))
        assert not is_degradable(_build.KernelBuildError("nvcc failed"))
        assert not is_degradable(_build.KernelLaunchError("CUDA error 1"))
        assert not is_degradable(RuntimeError("RESOURCE_EXHAUSTED: hbm"))
        assert not is_degradable(InjectedCrash("boom"))
        assert not is_degradable(ValueError("bad argument"))

    def test_kernel_build_failure_raises_under_resilient(self, uni,
                                                         monkeypatch):
        """A build failure is never demoted away from: a resilient run
        raises it (here from the batch dispatch, as a first CUDA launch
        would)."""
        def broken(*a, **k):
            raise _build.KernelBuildError("nvcc failed")

        monkeypatch.setattr(fp, "planar_sums", broken)
        with pytest.raises(_build.KernelBuildError):
            AlignedRMSF(uni, select="name CA", engine="fused").run(
                resilient=fast_policy(), batch_size=8,
                transfer_dtype="int16", **TORCH)

    def test_kernel_launch_failure_raises_under_resilient(self, uni,
                                                          monkeypatch):
        """A launch the card refused is not retried and not demoted
        away from: the next rung would do the work without the kernel,
        so a resilient run raises it."""
        calls = []

        def refused(*a, **k):
            calls.append(1)
            raise _build.KernelLaunchError("CUDA error 1")

        monkeypatch.setattr(fp, "planar_sums", refused)
        with pytest.raises(_build.KernelLaunchError):
            AlignedRMSF(uni, select="name CA", engine="fused").run(
                resilient=fast_policy(), batch_size=8,
                transfer_dtype="int16", **TORCH)
        assert len(calls) == 1

    def test_chain_with_single_serial(self, uni, oracle_rmsf):
        r = RMSF(uni.select_atoms("name CA")).run(
            resilient=fast_policy(), backend="serial")
        assert list(r.results.reliability["fallbacks"]) == []
        np.testing.assert_allclose(r.results.rmsf, oracle_rmsf, atol=1e-6)

    def test_rmsd_serial_resilient_runs(self, uni):
        """``RMSD(u).run(backend='serial', resilient=True)`` runs (the
        serial executor takes a reliability runtime)."""
        ref = RMSD(uni).run(backend="serial").results.rmsd
        r = RMSD(uni).run(backend="serial", resilient=True)
        np.testing.assert_array_equal(r.results.rmsd, ref)
        assert list(r.results.reliability["fallbacks"]) == []

    def test_fallback_chain_needs_executors(self):
        with pytest.raises(ValueError):
            FallbackChain([])

    def test_demotion_is_sticky_across_calls(self):
        class Boom:
            name = "boom"
            calls = 0

            def execute(self, *a, **k):
                Boom.calls += 1
                raise DeviceLossError("DEVICE_LOST")

        class Ok:
            name = "ok"
            calls = 0

            def execute(self, *a, **k):
                Ok.calls += 1
                return "partials"

        rt = ReliabilityRuntime(fast_policy())
        chain = FallbackChain([Boom(), Ok()], rt)
        stub = type("A", (), {})()
        assert chain.execute(stub, None, []) == "partials"
        assert chain.execute(stub, None, []) == "partials"
        assert Boom.calls == 1 and Ok.calls == 2
        assert len(rt.report.fallbacks) == 1

    def test_degradation_chain_inserts_generic_rung(self):
        """Mesh → Torch → Torch(generic) → Serial for quantized staging;
        the generic rung exists only where a fused kernel could run."""
        rt = ReliabilityRuntime(fast_policy())
        chain = degradation_chain(
            MeshExecutor(devices=["cpu"] * 2, transfer_dtype="int16",
                         scan_k=2), rt)
        assert [type(e).__name__ for e in chain] == [
            "MeshExecutor", "TorchExecutor", "TorchExecutor",
            "SerialExecutor"]
        assert [getattr(e, "use_quantized_native", None)
                for e in chain[1:3]] == [True, False]
        assert all(e.scan_k == 2 for e in chain[1:3])
        assert all(e.device == torch.device("cpu") for e in chain[1:3])
        f32 = degradation_chain(TorchExecutor(device="cpu"), rt)
        assert [type(e).__name__ for e in f32] == ["TorchExecutor",
                                                   "SerialExecutor"]

    def test_degradation_chain_on_the_card_keeps_the_kernel_rungs(
            self, monkeypatch):
        """On a CUDA device the chain has no generic rung and no Serial:
        Mesh → Torch, Torch alone."""
        from mdanalysis_mpi_tpu_torch.reliability import policy

        card = type("Card", (), {"device": torch.device("cuda")})()
        mesh = type("Mesh", (), {"devices": [torch.device("cpu"),
                                             torch.device("cuda", 1)]})()
        assert policy._on_card(card) and policy._on_card(mesh)
        assert not policy._on_card(TorchExecutor(device="cpu"))
        assert not policy._on_card(MeshExecutor(devices=["cpu"] * 2))
        monkeypatch.setattr(policy, "_on_card", lambda ex: True)
        rt = ReliabilityRuntime(fast_policy())
        chain = degradation_chain(
            MeshExecutor(devices=["cpu"] * 2, transfer_dtype="int16",
                         scan_k=2), rt)
        assert [type(e).__name__ for e in chain] == ["MeshExecutor",
                                                     "TorchExecutor"]
        assert chain[1].use_quantized_native
        one = TorchExecutor(device="cpu", transfer_dtype="int16")
        assert degradation_chain(one, rt) == [one]

    @pytest.mark.parametrize("checkpoint", [False, True])
    def test_exhausted_chain_on_the_card_raises(self, uni, tmp_path,
                                                monkeypatch, checkpoint):
        """A run on the card whose device rungs all give up raises; it
        never completes on the serial oracle (with or without the
        checkpointed route)."""
        from mdanalysis_mpi_tpu_torch.reliability import policy

        monkeypatch.setattr(policy, "_on_card", lambda ex: True)
        pol = fast_policy(checkpoint=checkpoint,
                          checkpoint_dir=str(tmp_path))
        with faults.inject(FaultSpec("kernel", "raise", times=None)):
            with pytest.raises(DeviceLossError):
                RMSF(uni.select_atoms("name CA")).run(
                    resilient=pol, batch_size=8, **TORCH)

    def test_user_executor_instance_restored(self, uni, oracle_rmsf):
        ex = TorchExecutor(batch_size=8, device="cpu")
        RMSF(uni.select_atoms("name CA")).run(
            resilient=fast_policy(), backend=ex)
        assert "reliability" not in ex.__dict__
        r = RMSF(uni.select_atoms("name CA")).run(backend=ex)
        assert "reliability" not in r.results
        np.testing.assert_allclose(r.results.rmsf, oracle_rmsf, atol=1e-3)

    def test_aligntraj_rejects_resilient_loudly(self, uni):
        with pytest.raises(ValueError, match="resilient"):
            AlignTraj(uni, uni, select="name CA",
                      in_memory=True).run(resilient=True)
        ju = jax_testing.make_protein_universe(n_residues=8,
                                               n_frames=N_FRAMES,
                                               noise=0.25, seed=3)
        with pytest.raises(ValueError, match="resilient"):
            jax_analysis.AlignTraj(ju, ju, select="name CA",
                                   in_memory=True).run(resilient=True)

    def test_flagship_two_pass_resilient(self, uni, tmp_path):
        ref = AlignedRMSF(uni, select="name CA").run(
            backend="serial").results.rmsf
        pol = ReliabilityPolicy(backoff_s=0.001,
                                checkpoint_dir=str(tmp_path))
        with faults.inject(FaultSpec("kernel", "raise", times=None)):
            r = AlignedRMSF(uni, select="name CA").run(
                resilient=pol, batch_size=8, **TORCH)
        np.testing.assert_allclose(r.results.rmsf, ref, atol=1e-6)
        assert not glob.glob(os.path.join(str(tmp_path), "mdtpu-ckpt-*"))
        assert r.results.reliability["fallbacks"]

    def test_flagship_surfaces_dropped_frames(self, uni, tmp_path):
        pol = ReliabilityPolicy(backoff_s=0.001,
                                checkpoint_dir=str(tmp_path))
        with faults.inject(*_persistent_corruption(5)):
            r = AlignedRMSF(uni, select="name CA").run(
                resilient=pol, batch_size=8, **TORCH)
        assert list(r.results.reliability["dropped_frames"]) == [5]

    def test_resilient_without_fault_stays_on_the_fused_rung(
            self, uni, tmp_path, monkeypatch):
        """No fault, no demotion: the fused function runs as often as in
        the plain run, and a block validation left alone stages the
        plain run's bytes, so the RMSF is the plain run's, bit for
        bit."""
        calls = []
        real = fp.planar_sums
        monkeypatch.setattr(fp, "planar_sums",
                            lambda *a: (calls.append(1), real(*a))[1])
        kw = dict(batch_size=8, transfer_dtype="int16", **TORCH)
        uni.trajectory.__dict__.pop("_quant_max_hints", None)
        plain = AlignedRMSF(uni, select="name CA", engine="fused").run(**kw)
        n_plain = len(calls)
        pol = ReliabilityPolicy(backoff_s=0.001,
                                checkpoint_dir=str(tmp_path))
        uni.trajectory.__dict__.pop("_quant_max_hints", None)
        r = AlignedRMSF(uni, select="name CA", engine="fused").run(
            resilient=pol, **kw)
        assert n_plain > 0 and len(calls) - n_plain == n_plain
        assert list(r.results.reliability["fallbacks"]) == []
        np.testing.assert_array_equal(r.results.rmsf, plain.results.rmsf)

    def test_injected_kernel_fault_demotes_fused_to_generic(self, uni,
                                                            tmp_path):
        """Off the card, three kernel faults exhaust the fused rung's
        retry budget (2 retries); the run demotes to the generic rung
        on the same device, as in the JAX package, which matches the
        fused run within the fused-vs-generic gate (5e-4 Å)."""
        kw = dict(batch_size=8, transfer_dtype="int16", **TORCH)
        plain = AlignedRMSF(uni, select="name CA", engine="fused").run(**kw)
        pol = ReliabilityPolicy(backoff_s=0.001,
                                checkpoint_dir=str(tmp_path))
        with faults.inject(FaultSpec("kernel", "raise", times=3)):
            r = AlignedRMSF(uni, select="name CA", engine="fused").run(
                resilient=pol, **kw)
        assert [(f, t) for f, t, _ in r.results.reliability["fallbacks"]
                ] == [("torch", "torch")]
        np.testing.assert_allclose(r.results.rmsf, plain.results.rmsf,
                                   atol=5e-4)

    def test_mesh_with_scan_prestage_and_reliability_runs(self, uni,
                                                          oracle_rmsf):
        m = MeshExecutor(batch_size=2, devices=["cpu"] * 2, scan_k=2,
                         prestage=True,
                         reliability=ReliabilityRuntime(fast_policy()),
                         block_cache=DeviceBlockCache())
        for _ in range(2):
            r = RMSF(uni.select_atoms("name CA")).run(backend=m)
            np.testing.assert_allclose(r.results.rmsf, oracle_rmsf,
                                       atol=1e-4)

    def test_mesh_only_ring_degrades_to_serial(self):
        boxed = make_protein_universe(n_residues=8, n_frames=8,
                                      noise=0.25, seed=3, box=30.0)
        g1 = boxed.select_atoms("name CA")
        ref = InterRDF(g1, g1, nbins=20, range=(0.5, 6.0)).run(
            backend="serial").results.rdf
        with faults.inject(FaultSpec("kernel", "raise", times=None)):
            r = InterRDF(g1, g1, nbins=20, range=(0.5, 6.0),
                         engine="ring").run(
                resilient=fast_policy(), batch_size=4,
                backend="mesh", devices=["cpu"] * 2)
        np.testing.assert_allclose(r.results.rdf, ref, rtol=1e-5)
        assert [(f, t) for f, t, _ in
                r.results.reliability["fallbacks"]] == [("mesh", "serial")]


# ---------------- the same schedules in both packages ----------------

SCHEDULES = {
    "skip": (lambda m: _persistent_corruption(5, m), {}),
    "heal": (lambda m: (m.FaultSpec("stage", "corrupt", frames=[3],
                                    times=1),), {}),
    "stage-retry": (lambda m: (m.FaultSpec("stage", "raise", times=2),), {}),
    "put-retry": (lambda m: (m.FaultSpec("put", "raise", times=1),), {}),
    "degrade": (lambda m: (m.FaultSpec("kernel", "raise", times=None),), {}),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_same_schedule_same_report_in_both_packages(name, uni):
    """One fault schedule, armed in each package's registry in turn:
    the two reports agree (the JAX package's ``jax`` backend name reads
    ``torch`` in the port) and so do the results."""
    make, extra = SCHEDULES[name]
    ju = jax_testing.make_protein_universe(n_residues=8, n_frames=N_FRAMES,
                                           noise=0.25, seed=3)
    with jax_faults.inject(*make(jax_faults)):
        j = jax_analysis.RMSF(ju.select_atoms("name CA")).run(
            resilient=JaxPolicy(backoff_s=0.001, checkpoint=False),
            backend="jax", batch_size=8, **extra)
    with faults.inject(*make(faults)):
        p = RMSF(uni.select_atoms("name CA")).run(
            resilient=fast_policy(), batch_size=8, **TORCH, **extra)
    jr, pr = j.results.reliability, p.results.reliability
    assert pr["retries"] == jr["retries"]
    assert pr["deadline_misses"] == jr["deadline_misses"]
    np.testing.assert_array_equal(pr["dropped_frames"], jr["dropped_frames"])
    np.testing.assert_array_equal(pr["healed_frames"], jr["healed_frames"])
    assert ([(f.replace("jax", "torch"), t.replace("jax", "torch"))
             for f, t, _ in jr["fallbacks"]]
            == [(f, t) for f, t, _ in pr["fallbacks"]])
    np.testing.assert_allclose(p.results.rmsf, np.asarray(j.results.rmsf),
                               atol=1e-4)


# ---------------- crash → checkpoint → resume ----------------

class TestAutoResume:
    def _policy(self, tmp_path, **kw):
        return ReliabilityPolicy(backoff_s=0.001, checkpoint_every=16,
                                 checkpoint_dir=str(tmp_path), **kw)

    def test_crash_then_resume_matches_uninterrupted(self, tmp_path):
        u = make_protein_universe(n_residues=8, n_frames=64, noise=0.25,
                                  seed=11)
        oracle = RMSF(u.select_atoms("name CA")).run(
            backend="serial").results.rmsf
        pol = self._policy(tmp_path)
        crash = FaultSpec("kernel", "raise", after=5, times=1,
                          exc=InjectedCrash)
        with faults.inject(crash):
            with pytest.raises(InjectedCrash):
                RMSF(u.select_atoms("name CA")).run(
                    resilient=pol, batch_size=8, **TORCH)
        (path,) = glob.glob(os.path.join(str(tmp_path), "mdtpu-ckpt-*"))
        with np.load(path) as z:
            assert int(z["frames_done"]) == 32
        counter = FaultSpec("kernel", "raise", times=0)
        with faults.inject(counter):
            r = RMSF(u.select_atoms("name CA")).run(
                resilient=pol, batch_size=8, **TORCH)
        assert counter.visits == 4
        np.testing.assert_allclose(r.results.rmsf, oracle, atol=1e-3)
        assert not glob.glob(os.path.join(str(tmp_path), "mdtpu-ckpt-*"))

    def test_default_true_uses_default_policy(self, uni, oracle_rmsf,
                                              monkeypatch, tmp_path):
        monkeypatch.setenv("MDTPU_CHECKPOINT_DIR", str(tmp_path))
        r = RMSF(uni.select_atoms("name CA")).run(
            resilient=True, batch_size=8, **TORCH)
        np.testing.assert_allclose(r.results.rmsf, oracle_rmsf, atol=1e-3)
        assert "reliability" in r.results
        assert not glob.glob(os.path.join(str(tmp_path), "mdtpu-ckpt-*"))

    def test_checkpoint_path_is_stable(self, uni, tmp_path):
        from mdanalysis_mpi_tpu_torch.utils.checkpoint import checkpoint_path

        a = RMSF(uni.select_atoms("name CA"))
        a._frame_indices = list(range(N_FRAMES))
        a.n_frames = N_FRAMES
        a._prepare()
        p1 = checkpoint_path(a, list(range(N_FRAMES)),
                             checkpoint_dir=str(tmp_path))
        p2 = checkpoint_path(a, list(range(N_FRAMES)),
                             checkpoint_dir=str(tmp_path))
        assert p1 == p2 and p1.startswith(str(tmp_path))
        assert p1 != checkpoint_path(a, list(range(N_FRAMES - 1)),
                                     checkpoint_dir=str(tmp_path))

    def test_resume_inherits_dropped_frames(self, tmp_path):
        u = make_protein_universe(n_residues=8, n_frames=64, noise=0.25,
                                  seed=11)
        pol = self._policy(tmp_path)
        specs = _persistent_corruption(5) + (
            FaultSpec("kernel", "raise", after=5, times=1,
                      exc=InjectedCrash),)
        with faults.inject(*specs):
            with pytest.raises(InjectedCrash):
                RMSF(u.select_atoms("name CA")).run(
                    resilient=pol, batch_size=8, **TORCH)
        r = RMSF(u.select_atoms("name CA")).run(
            resilient=pol, batch_size=8, **TORCH)
        assert list(r.results.reliability["dropped_frames"]) == [5]

    def test_chain_giveup_cleans_stale_checkpoint(self, tmp_path):
        u = make_protein_universe(n_residues=8, n_frames=64, noise=0.25,
                                  seed=11)
        pol = self._policy(tmp_path)
        with faults.inject(FaultSpec("kernel", "raise", times=None,
                                     after=2)):
            r = RMSF(u.select_atoms("name CA")).run(
                resilient=pol, batch_size=8, **TORCH)
        ref = RMSF(u.select_atoms("name CA")).run(
            backend="serial").results.rmsf
        np.testing.assert_allclose(r.results.rmsf, ref, atol=1e-3)
        assert r.results.reliability["fallbacks"]
        assert not glob.glob(os.path.join(str(tmp_path), "mdtpu-ckpt-*"))

    def test_giveup_with_serial_skip_still_cleans_checkpoint(self,
                                                             tmp_path):
        u = make_protein_universe(n_residues=8, n_frames=64, noise=0.25,
                                  seed=11)
        pol = self._policy(tmp_path)
        specs = (FaultSpec("kernel", "raise", times=None, after=2),
                 FaultSpec("read", "corrupt", frames=[40], times=None),
                 FaultSpec("stage", "corrupt", frames=[40], times=None))
        with faults.inject(*specs):
            r = RMSF(u.select_atoms("name CA")).run(
                resilient=pol, batch_size=8, **TORCH)
        assert 40 in list(r.results.reliability["dropped_frames"])
        assert not glob.glob(os.path.join(str(tmp_path), "mdtpu-ckpt-*"))
