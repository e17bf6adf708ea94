"""The port's staging traced from inside: the phases at the staging,
executor and analysis boundaries (``stage_wait``, ``gather``,
``repack``, ``chunk_read``, ``wire``, ``pass1``/``pass2``), the staging
counters and their run-report summary, the profiler bridge that puts the
leaf phases on a ``torch.profiler`` trace (every thread with
``profile_all_threads``), and the span document's ``wall0`` anchor that
lays a span file on that trace's clock.  CPU only; imports no JAX.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from mdanalysis_mpi_tpu_torch import obs
from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
from mdanalysis_mpi_tpu_torch.core.topology import Topology
from mdanalysis_mpi_tpu_torch.core.universe import Universe
from mdanalysis_mpi_tpu_torch.io import base as io_base
from mdanalysis_mpi_tpu_torch.io import native
from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader
from mdanalysis_mpi_tpu_torch.io.store import ingest
from mdanalysis_mpi_tpu_torch.lint import schema
from mdanalysis_mpi_tpu_torch.obs import metrics as obs_metrics
from mdanalysis_mpi_tpu_torch.obs import spans
from mdanalysis_mpi_tpu_torch.ops.fused_rmsf import ATOM_TILE
from mdanalysis_mpi_tpu_torch.utils import timers
from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS, device_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ATOMS, N_FRAMES, BATCH = 60, 64, 16
N_BLOCKS = N_FRAMES // BATCH
LEAVES = ("gather", "repack", "chunk_read", "wire", "decode")
#: never bridged: waits and enclosing phases
UNBRIDGED = ("stage_wait", "stage", "pass1", "pass2", "run", "execute",
             "dispatch")


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(scale=12.0, size=(N_ATOMS, 3)).astype(np.float32)
    return base[None] + rng.normal(
        scale=0.4, size=(N_FRAMES, N_ATOMS, 3)).astype(np.float32)


def _topology():
    names = np.tile(np.array(["CA", "HA"]), N_ATOMS // 2)
    return Topology(names=names, resnames=np.full(N_ATOMS, "ALA"),
                    resids=np.arange(N_ATOMS) // 2 + 1)


def _memory_universe():
    return Universe(_topology(), MemoryReader(_frames()))


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    """An int16 store of 16-frame chunks: one chunk a block."""
    out = str(tmp_path_factory.mktemp("staging") / "store")
    ingest(MemoryReader(_frames()), out, chunk_frames=BATCH, quant="int16")
    return out


@pytest.fixture(scope="module")
def split_store_dir(tmp_path_factory):
    """An int16 store of 8-frame chunks: two chunks a block."""
    out = str(tmp_path_factory.mktemp("staging") / "split")
    ingest(MemoryReader(_frames()), out, chunk_frames=BATCH // 2,
           quant="int16")
    return out


@pytest.fixture
def no_tracing():
    spans.disable(discard=True)
    yield
    spans.disable(discard=True)


def _run(u):
    """The fused int16 AlignedRMSF on the CPU → its RunReport."""
    a = AlignedRMSF(u, select="name CA", engine="fused").run(
        backend="torch", device="cpu", batch_size=BATCH,
        transfer_dtype="int16")
    return a.results.observability


# ------------------------------------------------------------- phases


@pytest.mark.parametrize("source", ["memory", "store"])
def test_staging_phases_are_called_once_a_block(source, store_dir,
                                                no_tracing):
    """Pass 1 stages every block (gather, the store's repack, the copy),
    and the dispatcher waits once on each; pass 2 reads the blocks pass
    1 left on the device and stages none.  The store reads each chunk
    once; from memory the native pass writes the planes itself, so no
    repack runs."""
    u = (_memory_universe() if source == "memory"
         else Universe(_topology(), store_dir))
    rep = _run(u)
    phases = rep["phases"]
    for name in ("stage", "gather", "wire", "stage_wait"):
        assert phases[name]["calls"] == N_BLOCKS, (name, phases)
    if source == "store":
        assert phases["chunk_read"]["calls"] == N_BLOCKS
        assert phases["repack"]["calls"] == N_BLOCKS
    else:
        assert "chunk_read" not in phases
        assert "repack" not in phases
    assert phases["pass1"]["calls"] == 1
    assert phases["pass2"]["calls"] == 1
    assert "read" not in phases


def test_store_repacks_each_chunk_slice(store_dir, split_store_dir,
                                       no_tracing):
    """A block over two chunks is gathered and repacked a chunk slice at
    a time and then joined (the join timed as one more ``gather``): a
    repack counts chunk slices, as ``mdtpu_fused_planar_repacks_total``
    does, and the answer is the one-chunk store's."""
    def rmsf(path):
        a = AlignedRMSF(Universe(_topology(), path), select="name CA",
                        engine="fused").run(
            backend="torch", device="cpu", batch_size=BATCH,
            transfer_dtype="int16")
        return np.asarray(a.results.rmsf), a.results.observability

    whole, _ = rmsf(store_dir)
    repacks0 = obs.METRICS.counter("mdtpu_fused_planar_repacks_total")
    split, rep = rmsf(split_store_dir)
    np.testing.assert_array_equal(split, whole)
    repacks1 = obs.METRICS.counter("mdtpu_fused_planar_repacks_total")
    phases = rep["phases"]
    assert phases["chunk_read"]["calls"] == 2 * N_BLOCKS
    assert phases["repack"]["calls"] == 2 * N_BLOCKS
    assert phases["gather"]["calls"] == 3 * N_BLOCKS
    assert phases["stage"]["calls"] == N_BLOCKS
    assert repacks1.get("", 0) - repacks0.get("", 0) == 2 * N_BLOCKS
    assert rep["staging"]["blocks"] == {"store_direct": N_BLOCKS}


def test_leaf_phases_nest_inside_stage(no_tracing):
    """gather runs inside stage on the staging thread: its seconds are
    no more than stage's (unrounded timer deltas); from memory the
    planar int16 pass is all gather, and no repack runs."""
    acc0, _ = TIMERS.snapshot()
    _run(_memory_universe())
    acc1, _ = TIMERS.snapshot()

    def d(name):
        return acc1.get(name, 0.0) - acc0.get(name, 0.0)

    assert d("gather") > 0 and d("repack") == 0
    assert d("gather") + d("repack") <= d("stage")


def test_store_leaves_nest_inside_stage(store_dir, no_tracing):
    """From a store the chunk reads of staged blocks nest in stage too;
    the reference frame's chunk is read before staging and is then
    served from the reader's cache."""
    u = Universe(_topology(), store_dir)
    acc0, _ = TIMERS.snapshot()
    _run(u)
    acc1, _ = TIMERS.snapshot()

    def d(name):
        return acc1.get(name, 0.0) - acc0.get(name, 0.0)

    assert d("gather") + d("repack") <= d("stage")
    assert d("chunk_read") > 0


def test_pass_phases_replace_the_pass_span(tmp_path, no_tracing):
    """With tracing on, pass1/pass2 are spans of the same names on the
    run's thread, inside its run span, and no ``pass`` span remains."""
    obs.enable_tracing()
    _run(_memory_universe())
    obs.disable_tracing()
    doc = spans.document()
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    names = [e["name"] for e in xs]
    assert names.count("pass1") == 1 and names.count("pass2") == 1
    assert "pass" not in names and "read" not in names
    run = [e for e in xs if e["name"] == "run"][-1]
    for e in xs:
        if e["name"] in ("pass1", "pass2"):
            assert e["tid"] == run["tid"]
            assert run["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= run["ts"] + run["dur"] + 1.0
    p1 = next(e for e in xs if e["name"] == "pass1")
    assert p1["args"]["analysis"] == "AverageStructure"


# ----------------------------------------------------------- counters


def test_staging_summary_counts_paths_and_bytes(no_tracing):
    """The native planar path stages every block of pass 1; the bytes are the
    host tuples handed to the copy (planar int16 planes of the selection
    padded to the fused kernel's atom tile, the scale, the boxes and the
    float32 mask a block)."""
    rep = _run(_memory_universe())
    staging = rep["staging"]
    assert staging["blocks"] == {"native_planar": N_BLOCKS}
    padded = -(-(N_ATOMS // 2) // ATOM_TILE) * ATOM_TILE
    per_block = (3 * BATCH * padded * 2     # int16 planes
                 + 4                        # inverse scale
                 + BATCH * 6 * 4            # boxes
                 + BATCH * 4)               # mask
    assert staging["bytes"] == N_BLOCKS * per_block


def test_store_staging_counts_the_direct_path(store_dir, no_tracing):
    rep = _run(Universe(_topology(), store_dir))
    assert rep["staging"]["blocks"] == {"store_direct": N_BLOCKS}


def test_numpy_fallback_is_counted_and_reported(monkeypatch, no_tracing):
    """A native failure in the planar pass falls back to NumPy: the
    block counts as ``path="numpy"``, in the registry and in the run
    report, and the fallback is logged once."""
    def broken(*a, **k):
        raise OSError("libtrajio.so: cannot open shared object file")

    for name in ("stage_gather_quantize", "stage_gather_quantize_scaled",
                 "stage_gather_quantize_planar",
                 "stage_gather_quantize_scaled_planar"):
        monkeypatch.setattr(native, name, broken)
    before = obs.METRICS.counter("mdtpu_stage_blocks_total").get(
        'path="numpy"', 0)
    rep = _run(_memory_universe())
    after = obs.METRICS.counter("mdtpu_stage_blocks_total").get(
        'path="numpy"', 0)
    assert after - before == N_BLOCKS
    assert rep["staging"]["blocks"] == {"numpy": N_BLOCKS}
    assert io_base._NUMPY_FALLBACK_LOGGED.is_set()


def test_a_run_that_stages_nothing_carries_no_summary(no_tracing):
    """The serial backend stages no block: its report keeps the JAX
    package's keys."""
    a = AlignedRMSF(_memory_universe(), select="name CA").run(
        backend="serial")
    assert "staging" not in a.results.observability


def test_staging_counters_are_pinned_and_in_the_snapshot():
    """The port pins its own staging table (the lint's
    PORT_PINNED_TABLES, harvested from obs/metrics.py), and a fresh
    snapshot carries every pinned name with its type."""
    pins = schema.harvest_port_pinned(
        os.path.join(REPO, "mdanalysis_mpi_tpu_torch", "obs", "metrics.py"))
    assert pins == {"mdtpu_stage_blocks_total": "counter",
                    "mdtpu_staged_bytes_total": "counter",
                    "mdtpu_xtc_decoded_bytes_total": "counter",
                    "mdtpu_xtc_redecodes_total": "counter",
                    "mdtpu_stage_threads": "gauge"}
    assert set(pins) == set(obs_metrics.STAGING_COUNTERS
                            + obs_metrics.STAGING_GAUGES)
    snap = obs_metrics.unified_snapshot(
        registry=obs_metrics.MetricsRegistry())
    for name, typ in pins.items():
        assert snap[name]["type"] == typ


# ------------------------------------------------- the profiler bridge


def _events(trace_dir):
    with open(os.path.join(trace_dir, "trace.json")) as f:
        return json.load(f)


def test_bridge_puts_staging_leaves_on_the_trace(tmp_path, no_tracing):
    """Under ``device_trace`` (every thread profiled), the prefetch
    thread's gather and wire are user annotations on a thread other
    than the one that opened the profile, once a block; no wait or
    enclosing phase is, and from memory no repack runs."""
    out = str(tmp_path / "trace")
    with device_trace(out):
        _run(_memory_universe())
    doc = _events(out)
    ann = [e for e in doc["traceEvents"]
           if e.get("cat") == "user_annotation"]
    main_tid = threading.get_native_id()
    for name in ("gather", "wire"):
        mine = [e for e in ann if e["name"] == name]
        assert len(mine) == N_BLOCKS, name
        assert all(e["tid"] != main_tid for e in mine), name
    names = {e["name"] for e in ann}
    assert not names & set(UNBRIDGED), names & set(UNBRIDGED)
    assert "repack" not in names


def test_no_record_function_without_a_profiler(monkeypatch, no_tracing):
    """With no profiler recording, the bridge enters no
    ``record_function``; with one recording, it enters one a leaf."""
    entered = []
    real = torch.autograd.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting)
    _run(_memory_universe())
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _run(_memory_universe())
    assert sorted(set(entered)) == ["gather", "wire"]
    assert len(entered) == 2 * N_BLOCKS


def test_only_leaves_are_bridged():
    assert timers.BRIDGED_PHASES == frozenset(LEAVES)
    assert not timers.BRIDGED_PHASES & set(UNBRIDGED)


def test_spans_and_annotations_share_the_wall_clock(tmp_path, no_tracing):
    """A bridged phase's span and its annotation start within 1 ms of
    each other once ``otherData.wall0`` and ``baseTimeNanoseconds`` are
    applied."""
    spans.reset()
    obs.enable_tracing()
    out = str(tmp_path / "trace")
    with device_trace(out):
        _run(_memory_universe())
    obs.disable_tracing()
    sdoc = spans.document()
    tdoc = _events(out)
    wall0 = sdoc["otherData"]["wall0"]
    base = tdoc["baseTimeNanoseconds"] / 1000.0

    def starts(events, name, origin, cat):
        return sorted(origin + e["ts"] for e in events
                      if e.get("name") == name and e.get("ph") == "X"
                      and e.get("cat") == cat)

    for name in ("gather", "wire"):
        s = starts(sdoc["traceEvents"], name, wall0, "mdtpu")
        t = starts(tdoc["traceEvents"], name, base, "user_annotation")
        assert len(s) == len(t) == N_BLOCKS
        assert max(abs(a - b) for a, b in zip(s, t)) < 1000.0, name


def test_span_document_carries_its_wall_clock_anchor(no_tracing):
    t0, wall0 = spans.clock_info()
    doc = spans.document()
    assert doc["otherData"]["wall0"] == pytest.approx(wall0 * 1e6, abs=1)
    assert doc["otherData"]["dropped_events"] == 0
