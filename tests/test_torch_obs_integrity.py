"""The port's ``utils/integrity.py``, ``obs/``, ``reliability/breaker.py``
and the fault-injection mirror against the JAX package's copies.

Checksums, record CRCs, staged-block fingerprints and content digests
must equal the JAX package's on the same inputs (made with numpy from a
seed): a store or checkpoint either package wrote verifies in the
other.  The port's known-metric registry (the zero-injected name
tuples of ``obs/metrics.py``) equals the JAX package's, and so does the
Prometheus rendering of the same series, and so does the store-read
usage split.  ``obs/usage.reconcile`` on a journal path reads the
journal through the port's ``service/journal``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from mdanalysis_mpi_tpu.obs import metrics as jmetrics  # noqa: E402
from mdanalysis_mpi_tpu.utils import integrity as jintegrity  # noqa: E402

from mdanalysis_mpi_tpu_torch import obs  # noqa: E402
from mdanalysis_mpi_tpu_torch.obs import metrics, usage  # noqa: E402
from mdanalysis_mpi_tpu_torch.reliability import breaker, faults  # noqa: E402
from mdanalysis_mpi_tpu_torch.utils import integrity  # noqa: E402


def _counter(name: str) -> float:
    return sum(obs.METRICS.snapshot().get(
        name, {"values": {}})["values"].values())


def _blobs():
    rng = np.random.default_rng(3)
    return [b"", b"a", b"123456789",
            rng.integers(0, 256, size=1000, dtype=np.uint8).tobytes()]


def test_crc32c_equals_jax_and_known_vector():
    # the Castagnoli check value of "123456789"
    assert integrity.crc32c(b"123456789") == 0xE3069283
    for blob in _blobs():
        assert integrity.crc32c(blob) == jintegrity.crc32c(blob)
        # chained like zlib.crc32
        assert integrity.crc32c(blob, 0x1234) \
            == jintegrity.crc32c(blob, 0x1234)


def test_record_crc_equals_jax_and_verifies_across():
    rng = np.random.default_rng(4)
    recs = [{}, {"a": 1, "b": [1, 2.5, "x"]},
            {"n_frames": int(rng.integers(1, 10 ** 6)), "quant": "int16",
             "nested": {"z": None, "y": float(rng.normal())}},
            {"crc": "ignored", "k": "v"}]
    for rec in recs:
        assert integrity.record_crc(rec) == jintegrity.record_crc(rec)
        stamped = dict(rec, crc=jintegrity.record_crc(rec))
        assert integrity.verify_record(stamped)
        assert not integrity.verify_record(dict(stamped, extra=1))


def test_staged_fingerprint_equals_jax_and_chains():
    rng = np.random.default_rng(5)
    q = rng.integers(-32767, 32767, size=(3, 16, 40), dtype=np.int16)
    boxes = rng.normal(size=(16, 6)).astype(np.float32)
    mask = np.ones(16, np.float32)
    staged = (q, np.float32(0.01), boxes, mask)
    fp = integrity.staged_fingerprint(staged)
    assert fp == jintegrity.staged_fingerprint(staged)
    # a non-contiguous view fingerprints its C-order bytes
    view = q.transpose(1, 0, 2)
    assert integrity.staged_fingerprint((view,)) \
        == jintegrity.staged_fingerprint((view,))
    # block-by-block chaining equals the stacked superblock's value
    b2 = (q[:, ::-1].copy(), np.float32(0.02), boxes + 1, mask)
    chained = integrity.staged_fingerprint(b2, fp)
    stacked = tuple(np.stack([a, b]) for a, b in zip(staged, b2))
    assert chained == integrity.staged_fingerprint(stacked)
    assert chained == jintegrity.staged_fingerprint(b2, fp)


def test_digest_arrays_and_npz_verify_across(tmp_path):
    rng = np.random.default_rng(6)
    arrays = {"rmsf": rng.normal(size=50),
              "counts": rng.integers(0, 9, size=(4, 3)),
              "q": rng.integers(-5, 5, size=7).astype(np.int16)}
    d = integrity.digest_arrays(arrays)
    assert d == jintegrity.digest_arrays(arrays)
    assert d == integrity.digest_arrays(
        dict(arrays, **{integrity.DIGEST_KEY: np.zeros(1)}))
    p, jp = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    integrity.write_npz_atomic(p, arrays)
    jintegrity.write_npz_atomic(jp, arrays)
    for path in (p, jp):
        for verify in (integrity.verify_npz, jintegrity.verify_npz):
            got = verify(path)
            assert sorted(got) == sorted(arrays)
            for k in arrays:
                np.testing.assert_array_equal(got[k], arrays[k])


def test_corrupt_npz_raises_typed_and_counts(tmp_path):
    p = str(tmp_path / "r.npz")
    integrity.write_npz_atomic(p, {"x": np.arange(5.0)})
    z = dict(np.load(p))
    z["x"] = z["x"] + 1.0                    # content no longer matches
    np.savez(p.replace(".npz", ""), **z)
    before = _counter("mdtpu_integrity_corrupt_total")
    with pytest.raises(integrity.ResultCorruptError):
        integrity.verify_npz(p)
    assert _counter("mdtpu_integrity_corrupt_total") == before + 1


@pytest.mark.parametrize("artifact,exc", [
    ("store", "StoreCorruptError"), ("journal", "JournalCorruptError"),
    ("checkpoint", "CheckpointCorruptError"),
    ("npz", "ResultCorruptError"), ("trace", "IntegrityError")])
def test_integrity_error_taxonomy_matches_jax(artifact, exc):
    e = integrity.integrity_error(artifact, "bad", "/x")
    je = jintegrity.integrity_error(artifact, "bad", "/x")
    assert type(e).__name__ == type(je).__name__ == exc
    assert isinstance(e, integrity.IntegrityError)
    assert str(e) == str(je)


def _name_tables(mod) -> dict:
    return {k: v for k, v in vars(mod).items()
            if isinstance(v, tuple) and v
            and all(isinstance(x, str) for x in v)}


def test_known_metric_registry_equals_jax():
    port, ref = _name_tables(metrics), _name_tables(jmetrics)
    assert "_TELEMETRY_COUNTERS" in port and "FUSED_COUNTERS" in port
    assert port == ref
    assert metrics.TIME_BUCKETS == jmetrics.TIME_BUCKETS
    # the zero-injected schema of a fresh registry is the same document
    snap = metrics.unified_snapshot(registry=metrics.MetricsRegistry())
    jsnap = jmetrics.unified_snapshot(registry=jmetrics.MetricsRegistry())
    assert snap == jsnap
    assert "mdtpu_fused_planar_repacks_total" in snap
    assert "mdtpu_store_chunks_read_total" in snap


def test_prometheus_rendering_equals_jax():
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for r in (reg, jreg):
        r.inc("mdtpu_store_chunks_read_total", 3)
        r.inc("mdtpu_store_chunk_crc_rejects_total", reason="corrupt")
        r.set_gauge("mdtpu_breaker_state", 2, backend="remote")
        for v in (0.003, 0.2, 7.0):
            r.observe("mdtpu_dispatch_ms", v, geometry="bs512")
    assert metrics.to_prometheus(reg.snapshot()) \
        == jmetrics.to_prometheus(jreg.snapshot())


def test_breaker_transitions_counted_on_port_metrics():
    t = [0.0]
    br = breaker.CircuitBreaker(("remote-test", None), threshold=2,
                                cooldown_s=5.0, clock=lambda: t[0])
    before = _counter("mdtpu_breaker_transitions_total")
    br.record_failure()
    assert br.state == breaker.CLOSED and br.allow()
    br.record_failure()
    assert br.state == breaker.OPEN and not br.allow()
    t[0] = 6.0
    assert br.state == breaker.HALF_OPEN
    br.record_success()
    assert br.state == breaker.CLOSED and br.trips == 1
    assert _counter("mdtpu_breaker_transitions_total") == before + 3
    board = breaker.BreakerBoard(threshold=1)
    assert board.get("a") is board.get("a")
    assert board.get("a") is not board.get("a", mesh="m1")


def test_injected_fault_is_counted():
    before = _counter("mdtpu_faults_injected_total")
    spec = faults.FaultSpec("read", "raise", times=1)
    faults.arm(spec)
    try:
        with pytest.raises(Exception, match="injected fault"):
            faults.fire("read")
    finally:
        faults.disarm(spec)
    assert _counter("mdtpu_faults_injected_total") == before + 1


def _charge_store_in_context(pkg_usage, pkg_spans):
    """Charge one store read under a serving context on a fresh ledger
    of ``pkg_usage`` (its global LEDGER restored after)."""
    ledger = pkg_usage.UsageLedger(registry=type(
        pkg_usage.LEDGER.registry)())
    ledger.enable()
    saved, pkg_usage.LEDGER = pkg_usage.LEDGER, ledger
    try:
        weights = [("a", "gold", 3), ("b", "std", 1), ("c", "std", 2)]
        with pkg_spans.context(usage_weights=weights):
            pkg_usage.charge_current_store("remote", chunks=5,
                                           nbytes=1001)
        # outside a serving context a direct run is not charged
        pkg_usage.charge_current_store("local", chunks=7, nbytes=9)
    finally:
        pkg_usage.LEDGER = saved
    return ledger.rows(), pkg_usage.ledger_from_snapshot(
        ledger.registry.snapshot())


def test_store_read_usage_split_equals_jax():
    from mdanalysis_mpi_tpu.obs import spans as jspans
    from mdanalysis_mpi_tpu.obs import usage as jusage
    from mdanalysis_mpi_tpu_torch.obs import spans

    rows, fed = _charge_store_in_context(usage, spans)
    jrows, jfed = _charge_store_in_context(jusage, jspans)
    assert rows == jrows and fed == jfed == rows
    # largest-remainder split of 5 chunks over weights 3:1:2: the
    # shares 2.5, 0.83, 1.67 floor to 2, 0, 1 and the two largest
    # remainders (b, c) take the 2 left over
    assert [rows[k]["store_chunks[remote]"] for k in
            (("a", "gold"), ("b", "std"), ("c", "std"))] == [2, 1, 2]


def test_span_events_recorded_only_while_tracing(tmp_path):
    from mdanalysis_mpi_tpu_torch.obs import spans

    spans.disable(discard=True)
    assert obs.span("read") is spans.NOOP
    obs.span_event("retry", attempt=1)
    assert spans.n_events() == 0
    path = str(tmp_path / "trace.json")
    obs.enable_tracing(path)
    try:
        with obs.trace_context(trace_id="t1"):
            with obs.span("stage", block=0):
                obs.span_event("store_chunk_rejected", chunk=2)
        assert obs.export_trace() == path
    finally:
        spans.disable(discard=True)
    import json
    doc = json.load(open(path))
    evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    assert [(e["ph"], e["name"]) for e in evs] \
        == [("i", "store_chunk_rejected"), ("X", "stage")]
    assert all(e["args"]["trace_id"] == "t1" for e in evs)
    assert doc["otherData"]["dropped_events"] == 0


@pytest.mark.parametrize("total,weights", [
    (5, [3, 1, 2]), (7, [1, 1, 1]), (0, [2, 5]), (9, [0, 0]),
    (1001, [512, 512, 24]), (0.75, [3, 1, 2]), (2.5, [1])])
def test_split_amount_equals_jax(total, weights):
    from mdanalysis_mpi_tpu.obs import usage as jusage

    shares = usage.split_amount(total, weights)
    assert shares == jusage.split_amount(total, weights)
    assert sum(shares) == pytest.approx(total, abs=0)


def _record_incidents(sp):
    sp.disable(discard=True)
    sp.enable()
    try:
        with sp.context(trace_id="job-a"):
            with sp.span("stage"):
                sp.span_event("retry", attempt=1)
        sp.span_event("breaker_open")            # no job context
        with sp.context(trace_ids=["job-b", "job-c"]):
            sp.span_event("frame_drop")
        return [[(e["ph"], e["name"]) for e in sp.tail(trace_id=t)]
                for t in ("job-a", "job-c", "job-z")]
    finally:
        sp.disable(discard=True)


def test_tail_by_trace_id_equals_jax():
    from mdanalysis_mpi_tpu.obs import spans as jspans
    from mdanalysis_mpi_tpu_torch.obs import spans

    got = _record_incidents(spans)
    assert got == _record_incidents(jspans)
    assert got[0] == [("i", "retry"), ("X", "stage"),
                      ("i", "breaker_open")]
    assert got[2] == [("i", "breaker_open")]


def test_event_ring_evicts_oldest_and_discloses(monkeypatch):
    from mdanalysis_mpi_tpu_torch.obs import spans

    monkeypatch.setattr(spans, "MAX_EVENTS", 3)
    spans.disable(discard=True)
    spans.enable()
    try:
        for k in range(5):
            spans.span_event(f"e{k}")
        assert [e["name"] for e in spans.tail()] == ["e2", "e3", "e4"]
        doc = spans.document()
    finally:
        spans.disable(discard=True)
    assert doc["otherData"]["dropped_events"] == 2
    # the thread's row label survives the eviction of its first event
    assert [e["ph"] for e in doc["traceEvents"]] == ["M", "i", "i", "i"]


def test_saved_context_attributes_another_thread():
    import threading

    from mdanalysis_mpi_tpu_torch.obs import spans

    spans.disable(discard=True)
    spans.enable()
    try:
        with spans.context(trace_id="job-a", tenant="t1"):
            captured = spans.current_context()
            assert spans.current_trace_ids() == frozenset({"job-a"})

        def stage():
            assert spans.current_context() is None
            with spans.saved_context(captured):
                spans.span_event("chunk_read")
            spans.span_event("unattributed")

        th = threading.Thread(target=stage)
        th.start()
        th.join()
        evs = spans.tail()
    finally:
        spans.disable(discard=True)
    assert spans.saved_context(None) is spans.NOOP
    assert [(e["name"], e.get("args")) for e in evs] == [
        ("chunk_read", {"trace_id": "job-a", "tenant": "t1"}),
        ("unattributed", None)]


def test_journal_reconcile_names_a10(tmp_path):
    """``reconcile`` on a journal path replays it (the port's
    ``service/journal``): a job served through a journaled scheduler
    reconciles one-for-one, exactly as on the replayed dict."""
    from mdanalysis_mpi_tpu_torch.analysis import RMSF
    from mdanalysis_mpi_tpu_torch.obs.metrics import unified_snapshot
    from mdanalysis_mpi_tpu_torch.service import Scheduler
    from mdanalysis_mpi_tpu_torch.service.journal import replay_fleet
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    path = str(tmp_path / "journal.jsonl")
    u = make_protein_universe(n_residues=6, n_frames=8, seed=3)
    base = unified_snapshot()
    with Scheduler(n_workers=1, journal=path) as sched:
        h = sched.submit(RMSF(u.select_atoms("name CA")),
                         backend="serial", tenant="reconcile-t1")
        h.result(timeout=60)
        assert sched.drain(timeout=60)
    snap = unified_snapshot()
    out = usage.reconcile(snap, path, baseline=base)
    assert out == usage.reconcile(snap, replay_fleet(path), baseline=base)
    assert out["ok"] is True, out["diff"]
    assert out["journal"] == {"reconcile-t1/done": 1}
    # a replayed journal dict reconciles without the journal module
    out = usage.reconcile({}, {"finishes": {}, "jobs": {}})
    assert out["ok"] is True and out["diff"] == {}
