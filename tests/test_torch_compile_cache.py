"""Twin of ``tests/test_compile_cache.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

Persistent compilation cache + AOT warmup (utils/compile_cache.py,
docs/COLDSTART.md).  The port keeps the counters of this module and the
warmup; its persistent tier and AOT tier (JAX's on-disk XLA cache,
``jit(...).lower().compile()``) have no port image and are not twinned:
``test_cache_dir_env_override`` and
``test_second_process_compiles_zero_new_executables`` (ROADMAP §C lists
them).  What is twinned is the counter contract: the port counts kernel
builds and CUDA-graph captures where the reference counts XLA compiles,
and the capture tag (``signature``) where it keys AOT executables.

The cold-path contract this file pins:

- compile activity is observable: jax's compile/cache events mirror
  into the obs metrics registry under the PINNED names;
- AOT warmup registers executables keyed by (op, shape, dtype,
  backend, scan_k) and ``execute`` binds its dispatches to them
  (``mdtpu_aot_dispatches_total`` moves) with serial-oracle parity;
- the TWO-PROCESS acceptance: with a shared cache dir, a second fresh
  process running the flagship-shaped protocol compiles ZERO new
  executables (``mdtpu_compile_cache_misses_total == 0``) and reaches
  its first result faster than the cold-cache process.
"""

import numpy as np
import pytest

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    port_runs_on_the_cpu)


def test_compile_metrics_zero_injected_without_jax_contact():
    """The pinned compile metric names appear (zeroed) in a unified
    snapshot from a registry that never saw a compile — the bench host
    legs' schema depends on this."""
    from mdanalysis_mpi_tpu_torch.obs.metrics import (
        COMPILE_METRICS, MetricsRegistry, unified_snapshot,
    )

    snap = unified_snapshot(registry=MetricsRegistry())
    for name in COMPILE_METRICS:
        assert name in snap
        assert snap[name]["type"] == "counter"


def test_compile_metric_names_match_jax_package():
    from mdanalysis_mpi_tpu.obs.metrics import COMPILE_METRICS as REF

    from mdanalysis_mpi_tpu_torch.obs.metrics import COMPILE_METRICS

    assert tuple(COMPILE_METRICS) == tuple(REF)


@pytest.mark.parametrize("kind", ["build", "graph"])
@pytest.mark.parametrize("prepared", [True, False])
def test_ensure_enabled_and_counters(kind, prepared):
    """A preparation (kernel build, graph capture) is a miss that moves
    ``mdtpu_compile_total`` and ``_seconds``; finding it prepared is a
    hit.  Both move ``counters()`` and the registry's labelled
    counters; a graph dispatch is a replay either way."""
    from mdanalysis_mpi_tpu_torch.obs.metrics import METRICS
    from mdanalysis_mpi_tpu_torch.utils import compile_cache as cc

    def snap():
        u = METRICS.snapshot()

        def val(name):
            return u.get(name, {}).get("values", {}).get(
                f'kind="{kind}"', 0)
        return {n: val(n) for n in (
            "mdtpu_compile_total", "mdtpu_compile_seconds",
            "mdtpu_compile_cache_hits_total",
            "mdtpu_compile_cache_misses_total")}

    c0, m0 = cc.counters(), snap()
    note = cc.note_build if kind == "build" else cc.note_graph
    note(prepared, 0.5)
    c1, m1 = cc.counters(), snap()
    miss, hit = f"{kind}_misses", f"{kind}_hits"
    assert c1[miss] - c0[miss] == int(prepared)
    assert c1[hit] - c0[hit] == int(not prepared)
    assert c1["replays"] - c0["replays"] == int(kind == "graph")
    assert (m1["mdtpu_compile_total"] - m0["mdtpu_compile_total"]
            == int(prepared))
    assert (m1["mdtpu_compile_seconds"] - m0["mdtpu_compile_seconds"]
            == pytest.approx(0.5 if prepared else 0.0))
    key = ("mdtpu_compile_cache_misses_total" if prepared
           else "mdtpu_compile_cache_hits_total")
    assert m1[key] - m0[key] == 1


def test_aot_warmup_binds_dispatch_with_parity():
    """warmup_analysis prepares the run's programs (the warmed counter
    and ``mdtpu_aot_compiled_total`` move); a following run matches the
    serial f64 oracle within the int16 staging tolerance."""
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
    from mdanalysis_mpi_tpu_torch.obs.metrics import METRICS
    from mdanalysis_mpi_tpu_torch.parallel.executors import (
        DeviceBlockCache, TorchExecutor, warmup_analysis,
    )
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe
    from mdanalysis_mpi_tpu_torch.utils import compile_cache as cc

    def aot():
        v = METRICS.snapshot().get("mdtpu_aot_compiled_total", {})
        return sum(v.get("values", {}).values())

    u = make_protein_universe(n_residues=24, n_frames=16, noise=0.3,
                              seed=3)
    oracle = AlignedRMSF(u, select="name CA").run(backend="serial")
    ex = TorchExecutor(batch_size=4,
                       block_cache=DeviceBlockCache(max_bytes=1 << 30),
                       transfer_dtype="int16")
    c0, a0 = cc.counters(), aot()
    n = warmup_analysis(AlignedRMSF(u, select="name CA"), ex,
                        batch_size=4)
    assert n >= 2            # both pass kernels at minimum
    assert cc.counters()["warmed"] - c0["warmed"] == n
    assert aot() - a0 == n
    r = AlignedRMSF(u, select="name CA").run(backend=ex, batch_size=4)
    np.testing.assert_allclose(r.results.rmsf, oracle.results.rmsf,
                               atol=1e-3)


def test_aot_key_distinguishes_shapes():
    """The capture tag's signature (the port's ``aot_key``) tells
    shapes, dtypes and host scalars apart and is stable."""
    import torch

    from mdanalysis_mpi_tpu_torch.utils import compile_cache as cc

    a4 = torch.zeros((4, 10, 3))
    a8 = torch.zeros((8, 10, 3))
    assert cc.signature((a4,)) != cc.signature((a8,))
    assert cc.signature((a4,)) != cc.signature((a4, 2))
    assert cc.signature((a4,)) != cc.signature((a4.double(),))
    assert cc.signature((a4,)) == cc.signature((torch.ones((4, 10, 3)),))
