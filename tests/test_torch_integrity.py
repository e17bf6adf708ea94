"""Twin of ``tests/test_integrity.py``: the JAX package's suite run
against the port on the CPU (``device="cpu"`` for every case;
``backend="jax"`` reads ``"torch"``, ROADMAP §C "'torch' for 'jax'").

End-to-end data integrity (docs/RELIABILITY.md §5).

Four layers, each proved on CPU, deterministically:

- **Primitives** — CRC32C vectors, record framing, chained
  staged-block fingerprints, digest-stamped atomic npz round trips,
  and the typed ENOSPC → ``ArtifactWriteError`` mapping.
- **Persistence boundaries** — journal CRC frames (interior
  corruption REJECTED, torn tail skipped), checkpoint digests
  (resume-from-corrupt raises typed), batch-CLI ``.npz`` outputs
  (write failure fails the JOB; ``--journal`` restart re-verifies and
  re-runs corrupt "done" outputs), journal in-memory degradation on a
  full disk.
- **SDC scrubbing** — the acceptance proof: with the ``bitflip``
  fault site armed, the scrubber detects the corrupted superblock via
  its stage-time fingerprint, quarantines it, and the affected job's
  re-staged result matches the solo serial oracle (plus the negative
  control: WITHOUT the scrub, the corruption reaches the result).
- **Byte-flip fuzz** — seeded random corruption over every persisted
  artifact: each flip yields a typed error or a clean
  skip-with-count, never silently wrong results.
"""

import errno
import json
import os
import zlib

import numpy as np
import pytest

from _torch_parity import (  # noqa: F401  (the fixture is autouse)
    assert_same, both, outcome, port_runs_on_the_cpu)


from mdanalysis_mpi_tpu_torch.analysis import RMSF  # noqa: E402
from mdanalysis_mpi_tpu_torch.obs import METRICS, unified_snapshot  # noqa: E402
from mdanalysis_mpi_tpu_torch.parallel.executors import (  # noqa: E402
    DeviceBlockCache, TorchExecutor, stage_analysis,
)
from mdanalysis_mpi_tpu_torch.reliability import faults  # noqa: E402
from mdanalysis_mpi_tpu_torch.service import Scheduler  # noqa: E402
from mdanalysis_mpi_tpu_torch.service.journal import JobJournal, replay  # noqa: E402
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe  # noqa: E402
from mdanalysis_mpi_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from mdanalysis_mpi_tpu_torch.utils import integrity  # noqa: E402

pytestmark = pytest.mark.integrity


def _u(n_frames=24, seed=9):
    return make_protein_universe(n_residues=30, n_frames=n_frames,
                                 noise=0.3, seed=seed)


def _counter(snap_name, **labels):
    from mdanalysis_mpi_tpu_torch.obs.metrics import label_key

    snap = METRICS.snapshot().get(snap_name, {"values": {}})
    return snap["values"].get(label_key(labels), 0)


# ---------------------------------------------------------- primitives


def test_crc32c_known_vectors():
    # RFC 3720 / Castagnoli check value for "123456789"
    assert integrity.crc32c(b"123456789") == 0xE3069283
    assert integrity.crc32c(b"") == 0
    # chaining == concatenation
    assert integrity.crc32c(b"world", integrity.crc32c(b"hello")) \
        == integrity.crc32c(b"helloworld")


def test_record_crc_round_trip_and_tamper():
    rec = {"ev": "submit", "fp": "0:abc", "t": 1.5, "tenant": "a"}
    rec["crc"] = integrity.record_crc(rec)
    assert integrity.verify_record(rec)
    rec["tenant"] = "b"
    assert not integrity.verify_record(rec)
    assert not integrity.verify_record({"ev": "submit"})  # no crc


def test_staged_fingerprint_chaining_matches_stacked_bytes():
    """The scan-group contract: chaining per-block fingerprints in
    block order equals fingerprinting the stacked superblock — the
    property that lets superblock fingerprints be recorded at stage
    time with no device fetch."""
    rng = np.random.default_rng(3)
    blocks = [(rng.integers(-100, 100, (4, 6, 3)).astype(np.int16),
               np.float32(0.5 + b),
               rng.random((4, 6)).astype(np.float32))
              for b in range(3)]
    acc = None
    for b in blocks:
        acc = integrity.staged_fingerprint(b, acc)
    stacked = tuple(np.stack([blk[i] for blk in blocks])
                    for i in range(3))
    assert acc == integrity.staged_fingerprint(stacked)
    # and it is really zlib.crc32 underneath (C speed on the hot path)
    assert acc[0] == zlib.crc32(
        b"".join(np.ascontiguousarray(blk[0]).tobytes()
                 for blk in blocks))


def test_write_npz_atomic_round_trip_and_corruption(tmp_path):
    path = str(tmp_path / "out.npz")
    arrays = {"a": np.arange(12.0).reshape(3, 4),
              "b": np.int64(7)}
    integrity.write_npz_atomic(path, arrays)
    loaded = integrity.verify_npz(path)
    np.testing.assert_array_equal(loaded["a"], arrays["a"])
    assert not os.path.exists(path + ".tmp")
    # flip one byte inside array a's payload -> typed refusal
    payload = np.ascontiguousarray(arrays["a"]).tobytes()
    blob = bytearray(open(path, "rb").read())
    at = bytes(blob).find(payload)
    assert at > 0
    blob[at] ^= 0x10
    open(path, "wb").write(bytes(blob))
    with pytest.raises(integrity.IntegrityError):
        integrity.verify_npz(path)


def test_verify_npz_requires_digest_stamp(tmp_path):
    path = str(tmp_path / "plain.npz")
    np.savez(path, a=np.zeros(3))
    with pytest.raises(integrity.IntegrityError):
        integrity.verify_npz(path)


def test_atomic_write_maps_oserror_to_typed(tmp_path):
    path = str(tmp_path / "x.bin")

    def writer(tmp):
        raise OSError(errno.ENOSPC, "No space left on device")

    before = _counter("mdtpu_integrity_write_errors_total",
                      artifact="unit-test")
    with pytest.raises(integrity.ArtifactWriteError) as ei:
        integrity.atomic_write(path, writer, artifact="unit-test")
    assert ei.value.errno == errno.ENOSPC
    assert ei.value.artifact == "unit-test"
    assert isinstance(ei.value, OSError)      # routable both ways
    assert _counter("mdtpu_integrity_write_errors_total",
                    artifact="unit-test") == before + 1
    # a missing target directory maps the same way
    with pytest.raises(integrity.ArtifactWriteError):
        integrity.atomic_write_bytes(
            str(tmp_path / "no" / "such" / "dir" / "f"), b"x",
            artifact="unit-test")


def test_integrity_metrics_zero_injected():
    """Satellite: the new integrity/scrub/write-error series are in
    the process-invariant snapshot schema even before any incident."""
    snap = unified_snapshot(registry=type(METRICS)())
    for name in ("mdtpu_integrity_write_errors_total",
                 "mdtpu_integrity_verifications_total",
                 "mdtpu_integrity_corrupt_total",
                 "mdtpu_obs_write_errors_total",
                 "mdtpu_scrub_passes_total",
                 "mdtpu_scrub_blocks_total",
                 "mdtpu_scrub_corrupt_total"):
        assert snap[name] == {"type": "counter", "values": {"": 0}}
    for name in ("mdtpu_integrity_journal_degraded",
                 "mdtpu_staged_bytes_peak"):
        assert snap[name] == {"type": "gauge", "values": {"": 0}}


# ------------------------------------------------- journal integrity


def test_journal_interior_corruption_rejected_typed(tmp_path):
    path = str(tmp_path / "j.jsonl")
    with JobJournal(path) as j:
        j.record("submit", "a")
        j.record("finish", "a", state="done", durable=True)
        j.record("submit", "b")
    lines = open(path).read().splitlines()
    # corrupt an INTERIOR record so it still parses as JSON
    lines[1] = lines[1].replace('"done"', '"gone"')
    open(path, "w").write("\n".join(lines) + "\n")
    with pytest.raises(integrity.JournalCorruptError):
        replay(path)
    with pytest.raises(integrity.JournalCorruptError):
        Scheduler.recover(path)


def test_journal_missing_crc_rejected(tmp_path):
    path = str(tmp_path / "j.jsonl")
    with JobJournal(path) as j:
        j.record("submit", "a")
    with open(path, "a") as f:
        f.write('{"ev": "finish", "fp": "a", "state": "done"}\n')
        f.write(json.dumps({"ev": "submit", "fp": "b",
                            "crc": integrity.record_crc(
                                {"ev": "submit", "fp": "b"})}) + "\n")
    with pytest.raises(integrity.JournalCorruptError):
        replay(path)


def test_journal_legacy_crcless_grandfathered(tmp_path):
    """A journal written BEFORE CRC framing (no record carries a crc)
    replays with a warning — an upgrade must not strand a healthy
    crash journal.  A MIXED journal (some framed, some not) is still
    rejected (test_journal_missing_crc_rejected)."""
    path = str(tmp_path / "legacy.jsonl")
    with open(path, "w") as f:
        f.write('{"ev": "submit", "fp": "a", "t": 1.0}\n')
        f.write('{"ev": "finish", "fp": "a", "state": "done"}\n')
        f.write('{"ev": "submit", "fp": "b", "t": 2.0}\n')
    states = replay(path)
    assert states["a"]["state"] == "done"
    assert states["b"]["state"] == "queued"


def test_bitflip_site_explicit_raise_kind_honored():
    """FaultSpec('bitflip', kind='raise') must RAISE, not silently
    corrupt — only the omitted defaults flip to the SDC shape."""
    spec = faults.FaultSpec("bitflip", "raise", times=1)
    assert spec.kind == "raise"
    with faults.inject(spec):
        with pytest.raises(faults.InjectedTransientError):
            faults.fire("bitflip", array=np.zeros(4, np.int16))
    # and the omitted-kind default stays the corrupting site
    spec2 = faults.FaultSpec("bitflip", times=1)
    assert spec2.kind == "corrupt" and spec2.corrupt == "bitflip"


def test_journal_torn_tail_still_skipped(tmp_path):
    path = str(tmp_path / "j.jsonl")
    with JobJournal(path) as j:
        j.record("submit", "a")
    with open(path, "a") as f:
        f.write('{"ev": "finish", "fp": "a", "sta')
    assert replay(path)["a"]["state"] == "queued"


def test_journal_degrades_to_memory_on_write_failure(tmp_path):
    """ENOSPC mid-serve must not kill the scheduler: the journal
    flips to in-memory, counts loudly, and keeps accepting records."""

    class _FullDisk:
        closed = False

        def write(self, line):
            raise OSError(errno.ENOSPC, "No space left on device")

        def flush(self):
            pass

        def fileno(self):
            return 0

        def close(self):
            self.closed = True

    path = str(tmp_path / "j.jsonl")
    j = JobJournal(path)
    before = _counter("mdtpu_integrity_write_errors_total",
                      artifact="journal")
    j._f.close()
    j._f = _FullDisk()
    j.record("submit", "a")
    assert j.degraded
    assert [r["ev"] for r in j.memory_records] == ["submit"]
    # later records keep landing in memory, no further write attempts
    j.record("finish", "a", state="done", durable=True)
    assert [r["ev"] for r in j.memory_records] == ["submit", "finish"]
    assert _counter("mdtpu_integrity_write_errors_total",
                    artifact="journal") == before + 1
    snap = METRICS.snapshot()
    assert snap["mdtpu_integrity_journal_degraded"]["values"][""] == 1
    # the in-memory fallback is BOUNDED: a disk-exhaustion incident
    # must not morph into memory exhaustion over days of serving
    j.memory_max = 3
    for k in range(4):
        j.record("submit", f"x{k}")
    assert len(j.memory_records) == 3
    assert j.memory_dropped == 3      # 2+4 records through a cap of 3
    j.close()


# ----------------------------------------------- checkpoint integrity


def test_checkpoint_corruption_raises_typed(tmp_path):
    u = _u()
    ag = u.select_atoms("name CA")
    oracle = RMSF(ag).run(backend="serial")
    ck = str(tmp_path / "c.npz")
    a1 = RMSF(u.select_atoms("name CA"))
    ckpt.run_checkpointed(a1, ck, chunk_frames=8, backend="torch",
                          batch_size=4, delete_on_success=False)
    np.testing.assert_allclose(np.asarray(a1.results.rmsf),
                               oracle.results.rmsf, atol=1e-3)
    # flip a byte INSIDE a stored array's payload (located by content
    # — a flip in zip header padding would be inert): resume must
    # REFUSE, not report wrong numbers
    leaf0 = integrity.verify_npz(ck, artifact="checkpoint")["leaf_1"]
    payload = np.ascontiguousarray(leaf0).tobytes()
    blob = bytearray(open(ck, "rb").read())
    at = bytes(blob).find(payload)
    assert at > 0
    blob[at + len(payload) // 2] ^= 0x04
    open(ck, "wb").write(bytes(blob))
    with pytest.raises(integrity.CheckpointCorruptError):
        ckpt.run_checkpointed(RMSF(u.select_atoms("name CA")), ck,
                              chunk_frames=8, backend="torch",
                              batch_size=4)


def test_checkpoint_spills_on_exhausted_primary(tmp_path, monkeypatch):
    """The ENOSPC degradation ladder: a checkpoint whose primary dir
    is exhausted retries in MDTPU_SPILL_DIR, the run completes, and a
    resume finds the spill twin."""
    primary = tmp_path / "primary"
    spill = tmp_path / "spill"
    primary.mkdir()
    spill.mkdir()
    monkeypatch.setenv("MDTPU_SPILL_DIR", str(spill))

    real = integrity.write_npz_atomic

    def full_primary(path, arrays, artifact="npz"):
        if str(path).startswith(str(primary)):
            integrity.note_write_error(artifact, str(path))
            raise integrity.ArtifactWriteError(
                artifact, str(path),
                OSError(errno.ENOSPC, "No space left on device"))
        return real(path, arrays, artifact=artifact)

    monkeypatch.setattr(integrity, "write_npz_atomic", full_primary)
    u = _u()
    oracle = RMSF(u.select_atoms("name CA")).run(backend="serial")
    ck = str(primary / "c.npz")
    a1 = RMSF(u.select_atoms("name CA"))
    ckpt.run_checkpointed(a1, ck, chunk_frames=8, backend="torch",
                          batch_size=4, delete_on_success=False)
    np.testing.assert_allclose(np.asarray(a1.results.rmsf),
                               oracle.results.rmsf, atol=1e-3)
    assert not os.path.exists(ck)
    # the twin is namespaced by the PRIMARY path (basename collisions
    # in a shared spill dir must not cross-contaminate runs)
    spilled = ckpt._spill_twin(ck)
    assert os.path.dirname(spilled) == str(spill)
    assert os.path.exists(spilled)
    # a resume (fresh process shape: same call) finds the spill twin
    done = int(integrity.verify_npz(spilled,
                                    artifact="checkpoint")["frames_done"])
    assert done == u.trajectory.n_frames
    a2 = RMSF(u.select_atoms("name CA"))
    ckpt.run_checkpointed(a2, ck, chunk_frames=8, backend="torch",
                          batch_size=4)
    np.testing.assert_allclose(np.asarray(a2.results.rmsf),
                               oracle.results.rmsf, atol=1e-3)
    assert not os.path.exists(spilled)      # delete_on_success


# ------------------------------------------------------ SDC scrubbing


def test_scrub_acceptance_bitflip_detected_then_parity(tmp_path):
    """THE acceptance proof: arm the ``bitflip`` site, stage a
    job's superblocks via prefetch (fingerprints recorded from the
    clean host bytes, corruption lands on the device copy), scrub —
    the corrupted superblock is detected and quarantined — then run
    the job: it re-stages clean bytes and matches the solo serial
    oracle within f32 tolerance."""
    u = _u()
    oracle = RMSF(u.select_atoms("name CA")).run(backend="serial")

    cache = DeviceBlockCache(max_bytes=1 << 30)
    sched = Scheduler(n_workers=1, cache=cache, autostart=False)
    h = sched.submit(RMSF(u.select_atoms("name CA")), backend="torch",
                     batch_size=8,
                     executor_kwargs={"transfer_dtype": "int16"})
    with faults.inject(faults.FaultSpec("bitflip", times=1)):
        assert sched.prefetch_pending() > 0
    before = _counter("mdtpu_scrub_corrupt_total")
    stats = sched.scrub_now()
    assert stats["corrupt"] == 1 and stats["checked"] >= 1
    assert _counter("mdtpu_scrub_corrupt_total") == before + 1
    sched.start()
    assert sched.drain(timeout=120)
    sched.shutdown()
    assert h.error is None
    np.testing.assert_allclose(np.asarray(h.result().results.rmsf),
                               oracle.results.rmsf, atol=1e-3)
    # the scrubbed entry was re-staged and now verifies clean
    assert sched.scrub_now()["corrupt"] == 0


def test_scrub_negative_control_unscrubbed_corruption_reaches_result():
    """Without the scrub, the same bitflip DOES reach the result —
    the control that proves detection is load-bearing, and that the
    injected corruption is big enough for parity checks to see."""
    u = _u()
    oracle = RMSF(u.select_atoms("name CA")).run(backend="serial")
    cache = DeviceBlockCache(max_bytes=1 << 30)
    ex = TorchExecutor(batch_size=8, block_cache=cache,
                     transfer_dtype="int16")
    with faults.inject(faults.FaultSpec("bitflip", times=1)):
        stage_analysis(RMSF(u.select_atoms("name CA")), ex)
    r = RMSF(u.select_atoms("name CA")).run(
        backend="torch", batch_size=8, block_cache=cache,
        transfer_dtype="int16")
    err = np.abs(np.asarray(r.results.rmsf)
                 - oracle.results.rmsf).max()
    assert err > 1e-3


def test_scrub_background_thread(tmp_path):
    """``Scheduler(scrub=True)``: the background scrubber finds the
    corruption on its own, on idle cycles."""
    import time

    u = _u()
    cache = DeviceBlockCache(max_bytes=1 << 30)
    sched = Scheduler(n_workers=1, cache=cache, autostart=False,
                      scrub=True, scrub_interval_s=0.05)
    sched.submit(RMSF(u.select_atoms("name CA")), backend="torch",
                 batch_size=8,
                 executor_kwargs={"transfer_dtype": "int16"})
    with faults.inject(faults.FaultSpec("bitflip", times=1)):
        assert sched.prefetch_pending() > 0
    before = _counter("mdtpu_scrub_corrupt_total")
    sched.start()
    assert sched.drain(timeout=120)
    deadline = time.monotonic() + 30
    while (time.monotonic() < deadline
           and _counter("mdtpu_scrub_corrupt_total") == before):
        time.sleep(0.05)
    sched.shutdown()
    assert _counter("mdtpu_scrub_corrupt_total") == before + 1


# ------------------------------------------------- memory watchdog


def test_mem_guard_sheds_to_serial_with_parity():
    """A batch-backend job whose staged estimate would cross
    ``mem_guard_bytes`` runs SERIAL (counted), with identical
    results — backpressure before the allocator OOMs."""
    u = _u()
    oracle = RMSF(u.select_atoms("name CA")).run(backend="serial")
    cache = DeviceBlockCache(max_bytes=1 << 30)
    sched = Scheduler(n_workers=1, cache=cache, autostart=False,
                      mem_guard_bytes=1)       # nothing batch fits
    h = sched.submit(RMSF(u.select_atoms("name CA")), backend="torch",
                     batch_size=8)
    sched.start()
    assert sched.drain(timeout=120)
    sched.shutdown()
    assert h.error is None
    np.testing.assert_allclose(np.asarray(h.result().results.rmsf),
                               oracle.results.rmsf, atol=1e-4)
    assert sched.telemetry.snapshot()["admission_shed_serial"] == 1
    assert sched._staged_inflight == 0


def test_mem_guard_admits_within_budget_and_gauge():
    u = _u()
    cache = DeviceBlockCache(max_bytes=1 << 30)
    sched = Scheduler(n_workers=1, cache=cache, autostart=False,
                      mem_guard_bytes=1 << 30)
    h = sched.submit(RMSF(u.select_atoms("name CA")), backend="torch",
                     batch_size=8)
    sched.start()
    assert sched.drain(timeout=120)
    sched.shutdown()
    assert h.error is None
    assert sched.telemetry.snapshot()["admission_shed_serial"] == 0
    assert sched._staged_inflight == 0
    # the staged-pressure high-water gauge saw the admission
    snap = METRICS.snapshot()
    assert snap["mdtpu_staged_bytes_peak"]["values"][""] > 0
    assert cache.bytes_peak > 0


# --------------------------------------- disclosed obs write drops


def test_trace_export_failure_counted_not_raised(tmp_path):
    from mdanalysis_mpi_tpu_torch.obs import spans

    before = _counter("mdtpu_obs_write_errors_total", sink="trace")
    spans.enable(str(tmp_path / "no" / "such" / "dir" / "t.json"))
    try:
        with spans.span("x"):
            pass
        assert spans.export() is None        # swallowed BUT...
    finally:
        spans.disable(discard=True)
    assert _counter("mdtpu_obs_write_errors_total",
                    sink="trace") == before + 1


def test_log_json_append_failure_counted_not_raised(tmp_path,
                                                    monkeypatch):
    from mdanalysis_mpi_tpu_torch.utils.log import log_event

    monkeypatch.setenv("MDTPU_LOG_JSON",
                       str(tmp_path / "no" / "such" / "dir" / "e.jsonl"))
    before = _counter("mdtpu_obs_write_errors_total", sink="log_json")
    log_event("unit_test", k=1)              # must not raise
    assert _counter("mdtpu_obs_write_errors_total",
                    sink="log_json") == before + 1


# ------------------------------------------------- batch CLI surface


def test_cli_output_write_failure_fails_job_not_worker(tmp_path,
                                                       capsys):
    u = _u()
    jobs_file = tmp_path / "jobs.json"
    jobs_file.write_text(json.dumps({
        "defaults": {"backend": "serial", "select": "name CA"},
        "jobs": [
            {"analysis": "rmsf", "tenant": "good",
             "output": str(tmp_path / "good.npz")},
            {"analysis": "rmsf", "tenant": "lost",
             "output": str(tmp_path / "no" / "such" / "dir" / "x.npz")},
        ],
    }))
    from mdanalysis_mpi_tpu_torch.service.cli import batch_main

    rc = batch_main([str(jobs_file)], universe=u)
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 1
    states = {r["tenant"]: r["state"] for r in out["jobs"]}
    assert states == {"good": "done", "lost": "failed"}
    lost = next(r for r in out["jobs"] if r["tenant"] == "lost")
    assert "ArtifactWriteError" in lost["error"]
    # the good tenant's artifact is digest-stamped and verifies
    integrity.verify_npz(str(tmp_path / "good.npz"))


def test_cli_journal_restart_reverifies_outputs(tmp_path, capsys):
    """``--journal`` restart trust-but-verify: a job the journal says
    is done, whose npz was corrupted (or deleted) since, RE-RUNS
    instead of being skipped — and the re-run rewrites a verifying
    artifact."""
    u = _u()
    out_a = str(tmp_path / "a.npz")
    out_b = str(tmp_path / "b.npz")
    jobs_file = tmp_path / "jobs.json"
    jobs_file.write_text(json.dumps({
        "defaults": {"backend": "serial", "select": "name CA"},
        "jobs": [
            {"analysis": "rmsf", "tenant": "a", "stop": 12,
             "output": out_a},
            {"analysis": "rmsf", "tenant": "b", "stop": 16,
             "output": out_b},
        ],
    }))
    from mdanalysis_mpi_tpu_torch.service.cli import batch_main

    jpath = str(tmp_path / "j.jsonl")
    rc = batch_main([str(jobs_file), "--journal", jpath], universe=u)
    capsys.readouterr()
    assert rc == 0
    oracle = integrity.verify_npz(out_a)["rmsf"]

    # corrupt a's artifact (inside the rmsf payload, located by
    # content); b's stays good
    payload = np.ascontiguousarray(oracle).tobytes()
    blob = bytearray(open(out_a, "rb").read())
    at = bytes(blob).find(payload)
    assert at > 0
    blob[at] ^= 0x40
    open(out_a, "wb").write(bytes(blob))

    rc = batch_main([str(jobs_file), "--journal", jpath], universe=u)
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 0
    assert out["outputs_corrupt_rerun"] == 1
    assert out["recovered_skipped"] == 1          # b skipped, verified
    rerun = [r for r in out["jobs"] if not r.get("recovered")]
    assert len(rerun) == 1 and rerun[0]["tenant"] == "a"
    np.testing.assert_allclose(integrity.verify_npz(out_a)["rmsf"],
                               oracle, atol=1e-6)


# ------------------------------------------------- byte-flip fuzzing


def _flip(path: str, rng) -> None:
    blob = bytearray(open(path, "rb").read())
    i = int(rng.integers(0, len(blob)))
    blob[i] ^= 1 << int(rng.integers(0, 8))
    open(path, "wb").write(bytes(blob))


def _flip_at(path: str, offset: int, rng) -> None:
    blob = bytearray(open(path, "rb").read())
    blob[offset] ^= 1 << int(rng.integers(0, 8))
    open(path, "wb").write(bytes(blob))


def test_fuzz_journal_interior_flips_always_rejected(tmp_path):
    """Seeded single-byte flips anywhere in the journal's INTERIOR
    (everything before the torn-tail-eligible final line): every
    single one must raise the typed JournalCorruptError — a flipped
    interior record can break its JSON, its CRC, or a separating
    newline, and all three roads lead to rejection, never to a
    silently different replayed state."""
    rng = np.random.default_rng(1234)
    clean_path = str(tmp_path / "clean.jsonl")
    with JobJournal(clean_path) as j:
        for k in range(6):
            j.record("submit", f"job{k}", tenant=f"t{k}")
            if k % 2 == 0:
                j.record("claim", f"job{k}", worker="w0")
                j.record("finish", f"job{k}", state="done",
                         durable=True)
    clean_blob = open(clean_path, "rb").read()
    final_line = clean_blob.rstrip(b"\n").split(b"\n")[-1]
    # interior = before the newline that precedes the final line (a
    # flip of THAT newline merges the last two lines into one torn
    # final line — legitimate tail territory)
    interior_end = len(clean_blob) - len(final_line) - 1
    path = str(tmp_path / "f.jsonl")
    for trial in range(40):
        open(path, "wb").write(clean_blob)
        _flip_at(path, int(rng.integers(0, interior_end)), rng)
        with pytest.raises(integrity.JournalCorruptError):
            replay(path)


def test_fuzz_journal_tail_flips_typed_or_clean_skip(tmp_path):
    """Flips in the final-line region: either the typed rejection (the
    line still parses, CRC fails) or a clean skip of exactly that
    record (the crash-torn-tail contract) — the replayed state is
    never silently different in any other way."""
    rng = np.random.default_rng(77)
    clean_path = str(tmp_path / "clean.jsonl")
    with JobJournal(clean_path) as j:
        j.record("submit", "a")
        j.record("finish", "a", state="done", durable=True)
        j.record("submit", "b")
    clean_blob = open(clean_path, "rb").read()
    clean = replay(clean_path)
    minus_tail = {fp: st for fp, st in clean.items() if fp != "b"}
    final_line = clean_blob.rstrip(b"\n").split(b"\n")[-1]
    tail_start = len(clean_blob) - len(final_line) - 1
    path = str(tmp_path / "f.jsonl")
    outcomes = {"typed": 0, "skip": 0}
    for trial in range(30):
        open(path, "wb").write(clean_blob)
        _flip_at(path,
                 int(rng.integers(tail_start, len(clean_blob))), rng)
        try:
            got = replay(path)
        except integrity.JournalCorruptError:
            outcomes["typed"] += 1
            continue
        assert got == minus_tail, "silent replay corruption"
        outcomes["skip"] += 1
    assert outcomes["typed"] > 0 and outcomes["skip"] > 0


def test_fuzz_checkpoint_byte_flips_never_silent(tmp_path):
    u = _u()
    oracle = RMSF(u.select_atoms("name CA")).run(backend="serial")
    rng = np.random.default_rng(99)
    ck = str(tmp_path / "c.npz")
    a = RMSF(u.select_atoms("name CA"))
    ckpt.run_checkpointed(a, ck, chunk_frames=8, backend="torch",
                          batch_size=4, delete_on_success=False)
    clean = open(ck, "rb").read()
    typed = 0
    for trial in range(25):
        open(ck, "wb").write(clean)
        _flip(ck, rng)
        a2 = RMSF(u.select_atoms("name CA"))
        try:
            ckpt.run_checkpointed(a2, ck, chunk_frames=8,
                                  backend="torch", batch_size=4,
                                  delete_on_success=False)
        except (integrity.IntegrityError, ValueError):
            typed += 1        # typed refusal is the contract
            continue
        # accepted: the flip must have been inert (zip dead bytes) —
        # the resumed numbers must STILL match the oracle
        np.testing.assert_allclose(np.asarray(a2.results.rmsf),
                                   oracle.results.rmsf, atol=1e-3)
    assert typed > 0


def test_fuzz_npz_output_byte_flips_never_silent(tmp_path):
    rng = np.random.default_rng(7)
    path = str(tmp_path / "o.npz")
    arrays = {"x": np.arange(64.0), "y": np.ones((8, 3))}
    integrity.write_npz_atomic(path, arrays)
    clean = open(path, "rb").read()
    typed = 0
    for trial in range(25):
        open(path, "wb").write(clean)
        _flip(path, rng)
        try:
            got = integrity.verify_npz(path)
        except (integrity.IntegrityError, OSError):
            typed += 1
            continue
        # accepted: must be byte-identical content (inert flip)
        np.testing.assert_array_equal(got["x"], arrays["x"])
        np.testing.assert_array_equal(got["y"], arrays["y"])
    assert typed > 0


# ---------------- parity with the JAX package ----------------
# The reference cases' inputs through both packages: each case builds
# its input from a seed, runs it on one package's modules and returns
# what it computed; the JAX package's outcome and the port's must be
# equal (host bookkeeping) or within the reference case's tolerance.


@pytest.mark.parametrize("n", [0, 1, 7, 64, 4097])
def test_checksums_match_jax_package(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
    arrays = {"a": rng.normal(size=(n % 5 + 1, 3)).astype(np.float32),
              "b": np.arange(n % 7 + 1, dtype=np.int64)}
    rec = {"job": f"j{n}", "frames": n, "state": "done"}

    def case(mod):
        integ = mod("utils.integrity")
        return (integ.crc32c(data), integ.crc32c(data, 12345),
                integ.record_crc(dict(rec)), integ.digest_arrays(arrays),
                integ.verify_record(dict(rec, crc=integ.record_crc(rec))))
    assert_same(*both(case))


def test_npz_artifacts_cross_packages(tmp_path):
    """An npz written atomically by either package verifies in the
    other; a flipped byte is refused by both."""
    arrays = {"rmsf": np.linspace(0, 1, 9, dtype=np.float32)}

    def write(mod):
        path = str(tmp_path / f"{mod().__name__}.npz")
        mod("utils.integrity").write_npz_atomic(path, arrays)
        return path
    paths = both(write)
    with open(paths[0], "rb") as f0, open(paths[1], "rb") as f1:
        assert f0.read() == f1.read()
    for p in paths:
        got = both(lambda mod: outcome(
            lambda: mod("utils.integrity").verify_npz(p)))
        assert got[0][0] == "ok"
        assert_same(*got)
    raw = bytearray(open(paths[1], "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    bad = str(tmp_path / "bad.npz")
    open(bad, "wb").write(bytes(raw))
    ref, port = both(lambda mod: outcome(
        lambda: mod("utils.integrity").verify_npz(bad)))
    assert ref[0] == "raise" and ref == port
