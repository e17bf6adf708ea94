"""The port's serving tier against the JAX package's, on the same
inputs: the same job set served by each package's ``Scheduler`` gives
the same results, the same completion order and the same telemetry
counters; journals either package wrote replay in the other; the alert
engines fire the same transitions on the same snapshot sequence; the
``perf`` sentinels give the same verdicts on the same bench records.

The JAX package runs on the CPU (``backend="jax"``); the port runs its
device route on the CPU (``backend="torch"``, ``device="cpu"``).  On
the CPU the port's scheduler sheds to serial as the JAX package's does;
the card's rule (no route ends on serial) is exercised here with
``job_on_card`` forced true and on the card in ``tests/test_torch_cuda.py``.
"""

import copy
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import mdanalysis_mpi_tpu as jpkg  # noqa: E402
import mdanalysis_mpi_tpu_torch as tpkg  # noqa: E402
from mdanalysis_mpi_tpu.obs import alerts as jalerts  # noqa: E402
from mdanalysis_mpi_tpu.obs import baseline as jbaseline  # noqa: E402
from mdanalysis_mpi_tpu.service import journal as jjournal  # noqa: E402
from mdanalysis_mpi_tpu_torch.obs import alerts as talerts  # noqa: E402
from mdanalysis_mpi_tpu_torch.obs import baseline as tbaseline  # noqa: E402
from mdanalysis_mpi_tpu_torch.reliability import faults as tfaults  # noqa: E402
from mdanalysis_mpi_tpu_torch.service import journal as tjournal  # noqa: E402
from mdanalysis_mpi_tpu_torch.service import scheduler as tscheduler  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.service

#: telemetry counters a served workload must reproduce exactly
COUNTERS = ("jobs_submitted", "jobs_completed", "jobs_failed",
            "jobs_expired", "coalesced_jobs", "coalesce_batches",
            "solo_jobs", "uncoalescable_jobs", "coalesce_fallbacks",
            "admission_reserved", "admission_resident",
            "admission_deferrals", "admission_uncached",
            "admission_evictions", "admission_shed_serial",
            "jobs_quarantined", "jobs_shed", "breaker_reroutes")


class _Pkg:
    """One package's serving surface, and how it names its device
    route."""

    def __init__(self, pkg):
        import importlib

        self.name = pkg.__name__
        self.ana = importlib.import_module(self.name + ".analysis")
        self.service = importlib.import_module(self.name + ".service")
        self.executors = importlib.import_module(
            self.name + ".parallel.executors")
        self.faults = importlib.import_module(
            self.name + ".reliability.faults")
        self.breaker = importlib.import_module(
            self.name + ".reliability.breaker")
        self.testing = importlib.import_module(self.name + ".testing")
        self.port = self.name == "mdanalysis_mpi_tpu_torch"

    def device(self, **kw):
        """``(backend, executor_kwargs)`` of the device route."""
        if self.port:
            return "torch", dict(kw, device="cpu")
        return "jax", dict(kw)

    def universe(self, n_frames=32, seed=9):
        return self.testing.make_protein_universe(
            n_residues=30, n_frames=n_frames, noise=0.3, seed=seed)


JAX, PORT = _Pkg(jpkg), _Pkg(tpkg)


def _counters(sched) -> dict:
    snap = sched.telemetry.snapshot()
    return {k: snap[k] for k in COUNTERS}


def _order(handles) -> list:
    return [h.job.tenant for h in sorted(handles,
                                         key=lambda h: h.finished_t)]


# ---------------------------------------------------------------------------
# one mixed workload: coalesced, solo, uncoalescable, serial, expired
# ---------------------------------------------------------------------------


def _mixed(p: _Pkg):
    u = p.universe()
    backend, kw = p.device()
    cache = p.executors.DeviceBlockCache(max_bytes=1 << 30)
    sched = p.service.Scheduler(n_workers=1, cache=cache,
                                autostart=False)
    a = p.ana
    jobs = [
        (a.RMSF(u.select_atoms("name CA")), dict(priority=5,
                                                  tenant="rmsf-ca")),
        (a.RMSF(u.select_atoms("name CB")), dict(priority=5,
                                                  tenant="rmsf-cb")),
        (a.AverageStructure(u, select="name CA", select_only=True),
         dict(priority=5, tenant="avg")),
        (a.AlignedRMSF(u, select="name CA"), dict(priority=3,
                                                   tenant="aligned")),
        (a.RMSD(u.select_atoms("name CA")), dict(priority=1, stop=16,
                                                  tenant="rmsd")),
        (a.RadiusOfGyration(u.select_atoms("name CA")),
         dict(priority=1, stop=16, tenant="rgyr")),
    ]
    handles = [sched.submit(ana, backend=backend, executor_kwargs=kw,
                            batch_size=8, **extra)
               for ana, extra in jobs]
    handles.append(sched.submit(a.RMSF(u.select_atoms("name CA")),
                                backend="serial", priority=0,
                                tenant="serial"))
    handles.append(sched.submit(a.RMSF(u.select_atoms("name CA")),
                                backend=backend, executor_kwargs=kw,
                                batch_size=8, priority=-1,
                                deadline_s=0.0, tenant="expired"))
    sched.start()
    assert sched.drain(timeout=240)
    sched.shutdown()
    return handles, sched


def test_mixed_workload_results_order_and_counters_equal_jax():
    jh, js = _mixed(JAX)
    th, ts = _mixed(PORT)
    assert _counters(ts) == _counters(js)
    assert _order(th) == _order(jh)
    assert [h.state for h in th] == [h.state for h in jh]
    assert [h.coalesced for h in th] == [h.coalesced for h in jh]
    for j, t in zip(jh, th):
        if j.error is not None:
            assert type(t.error).__name__ == type(j.error).__name__
            continue
        jr = j.result().results.materialize()
        tr = t.result().results.materialize()
        for key in ("rmsf", "rmsd", "rgyr", "positions"):
            if key in jr:
                np.testing.assert_allclose(
                    np.asarray(tr[key]), np.asarray(jr[key]),
                    atol=1e-4, err_msg=f"{j.job.tenant}: {key}")


def test_memory_guard_sheds_to_serial_on_the_cpu_like_jax():
    """A unit whose estimate crosses ``mem_guard_bytes`` runs on the
    serial backend in both packages, counted alike, with the serial
    oracle's results."""
    out = {}
    for p in (JAX, PORT):
        u = p.universe()
        backend, kw = p.device()
        sched = p.service.Scheduler(n_workers=1, autostart=False,
                                    mem_guard_bytes=1)
        hs = [sched.submit(p.ana.RMSF(u.select_atoms(sel)),
                           backend=backend, executor_kwargs=kw,
                           batch_size=8, coalesce=False, tenant=sel)
              for sel in ("name CA", "name CB")]
        sched.start()
        assert sched.drain(timeout=120)
        sched.shutdown()
        out[p.name] = ([np.asarray(h.result().results.rmsf) for h in hs],
                       _counters(sched))
    (jr, jc), (tr, tc) = out.values()
    assert tc == jc and tc["admission_shed_serial"] == 2
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a, b, atol=1e-10)


def test_breaker_reroutes_to_serial_on_the_cpu_like_jax():
    """Two degradable kernel faults trip the device breaker; the next
    job routes to serial in both packages (the CPU keeps the JAX
    package's floor) with equal counters and breaker states."""
    out = {}
    for p in (JAX, PORT):
        u = p.universe()
        backend, kw = p.device()
        board = p.breaker.BreakerBoard(threshold=2, cooldown_s=1e9)
        sched = p.service.Scheduler(n_workers=1, breakers=board,
                                    supervision_interval_s=0.02)
        with p.faults.inject(p.faults.FaultSpec("kernel", "raise",
                                                times=None)):
            bad = [sched.submit(p.ana.RMSF(u.select_atoms("name CA")),
                                backend=backend, executor_kwargs=kw,
                                batch_size=8, stop=s) for s in (16, 24)]
            assert sched.drain(timeout=120)
        h = sched.submit(p.ana.RMSF(u.select_atoms("name CA")),
                         backend=backend, executor_kwargs=kw,
                         batch_size=8)
        assert sched.drain(timeout=120)
        sched.shutdown()
        out[p.name] = ([type(b.error).__name__ for b in bad],
                       np.asarray(h.result().results.rmsf),
                       _counters(sched), board.get(backend).state)
    (je, jr, jc, jst), (te, tr, tc, tst) = out.values()
    assert te == je and tc == jc and tst == jst == "open"
    assert tc["breaker_reroutes"] == 1
    np.testing.assert_allclose(tr, jr, atol=1e-10)


def test_poison_job_quarantined_like_jax(tmp_path):
    out = {}
    for p in (JAX, PORT):
        u = p.universe()

        class Poison(p.ana.RMSF):
            def _prepare(self, _f=p.faults):
                raise _f.InjectedWorkerDeath("poison tenant")

        sched = p.service.Scheduler(
            n_workers=1, poison_threshold=2, autostart=False,
            supervision_interval_s=0.02,
            journal=str(tmp_path / f"{p.name}.jsonl"))
        hp = sched.submit(p.service.AnalysisJob(
            Poison(u.select_atoms("name CA")), backend="serial",
            tenant="poison", fingerprint="poison", coalesce=False))
        hg = sched.submit(p.ana.RMSF(u.select_atoms("name CB")),
                          backend="serial", tenant="good",
                          coalesce=False)
        sched.start()
        assert sched.drain(timeout=120)
        sched.shutdown()
        out[p.name] = (hp.state, hg.state, _counters(sched),
                       p.service.Scheduler.recover(
                           str(tmp_path / f"{p.name}.jsonl"))
                       ["quarantined"])
    assert out[JAX.name] == out[PORT.name]
    assert out[PORT.name][0] == "quarantined"


def _admission(p: _Pkg):
    """Two tenants over a cache that holds one of them: the second is
    deferred behind the first tenant's pending job, then admitted by
    evicting the first tenant's idle entries."""
    u1, u2 = p.universe(seed=9), p.universe(seed=10)
    backend, kw = p.device()
    est = 32 * u1.atoms.n_atoms * 3 * 4           # one job's estimate
    cache = p.executors.DeviceBlockCache(max_bytes=est + 4096)
    sched = p.service.Scheduler(n_workers=1, cache=cache,
                                autostart=False)
    # u1's second job has a window of its own (another coalesce key),
    # so it is claimed alone and keeps u1's entries pinned meanwhile
    hs = [sched.submit(p.ana.RMSF(u.select_atoms("name CA")),
                       backend=backend, executor_kwargs=kw, batch_size=8,
                       coalesce=False, priority=pr, stop=stop, tenant=t)
          for u, pr, stop, t in ((u1, 3, None, "u1-first"),
                                 (u2, 2, None, "u2"),
                                 (u1, 1, 24, "u1-again"))]
    sched.start()
    assert sched.drain(timeout=120)
    sched.shutdown()
    return hs, sched


def _shed(p: _Pkg):
    """A gated job saturates the lone worker; a burst past the shed
    depth drops the background and batch jobs, never the interactive
    ones (the overload ladder, waited for with a time limit)."""
    u = p.universe()
    gate = threading.Event()

    class Gated(p.ana.RMSF):
        def _prepare(self):
            assert gate.wait(60.0)
            super()._prepare()

    sched = p.service.Scheduler(
        n_workers=1, autostart=False, supervision_interval_s=0.02,
        qos=p.service.QosPolicy(shed_queue_depth=2,
                                shed_classes=("background", "batch")))
    hs = [sched.submit(Gated(u.select_atoms("name CA")),
                       backend="serial", qos="interactive", priority=100,
                       coalesce=False, tenant="gate")]
    for i, cls in enumerate(("interactive", "interactive", "batch",
                             "batch", "background", "background")):
        hs.append(sched.submit(p.ana.RMSF(u.select_atoms("name CA")),
                               backend="serial", start=i, coalesce=False,
                               qos=cls, tenant=f"{cls}{i}"))
    sched.start()
    try:
        deadline = time.monotonic() + 60.0
        while (sched.telemetry.jobs_shed < 4
               and time.monotonic() < deadline):
            time.sleep(0.02)
    finally:
        gate.set()
    assert sched.drain(timeout=120)
    sched.shutdown()
    return hs, sched


@pytest.mark.parametrize("scenario", ["admission", "shed"])
def test_admission_and_shed_counters_equal_jax(scenario):
    make = {"admission": _admission, "shed": _shed}[scenario]
    (jh, js), (th, ts) = make(JAX), make(PORT)
    assert _counters(ts) == _counters(js)
    assert [h.state for h in th] == [h.state for h in jh]
    assert _order([h for h in th if h.finished_t]) == \
        _order([h for h in jh if h.finished_t])
    tq, jq = ts.telemetry.snapshot()["qos"], js.telemetry.snapshot()["qos"]
    assert {c: tq[c]["shed"] for c in tq} == {c: jq[c]["shed"] for c in jq}
    if scenario == "admission":
        c = _counters(ts)
        assert c["admission_deferrals"] >= 1
        assert c["admission_evictions"] >= 1
    else:
        assert _counters(ts)["jobs_shed"] == 4


# ---------------------------------------------------------------------------
# the card's routing rule, with the device check forced (CPU twin)
# ---------------------------------------------------------------------------


def test_on_card_open_breaker_refuses_typed_instead_of_serial(
        monkeypatch):
    """With ``job_on_card`` true, a job whose device breaker is open
    fails with ``BackendUnavailableError`` naming the breaker — it is
    never finished on serial — and after the cooldown the half-open
    probe closes the breaker and the job runs on the device route."""
    from mdanalysis_mpi_tpu_torch.service.jobs import (
        BackendUnavailableError)

    monkeypatch.setattr(tscheduler, "job_on_card", lambda job: True)
    t = [0.0]
    board = PORT.breaker.BreakerBoard(threshold=2, cooldown_s=30.0,
                                      clock=lambda: t[0])
    u = PORT.universe()
    sched = PORT.service.Scheduler(n_workers=1, breakers=board,
                                   supervision_interval_s=0.02)
    try:
        with tfaults.inject(tfaults.FaultSpec("kernel", "raise",
                                              times=None)):
            for s in (16, 24):
                sched.submit(PORT.ana.RMSF(u.select_atoms("name CA")),
                             backend="torch", executor_kwargs=PORT
                             .device()[1], batch_size=8, stop=s)
            assert sched.drain(timeout=120)
        assert board.get("torch").state == "open"
        h = sched.submit(PORT.ana.RMSF(u.select_atoms("name CA")),
                         backend="torch", executor_kwargs=PORT.device()[1],
                         batch_size=8)
        assert sched.drain(timeout=120)
        with pytest.raises(BackendUnavailableError, match="'torch'") as ei:
            h.result(timeout=1)
        assert ei.value.breakers == ("torch",)
        assert h.state == "failed"
        assert sched.telemetry.breaker_reroutes == 0
        assert "rmsf" not in h.job.analysis.results    # never ran
        # a mesh job walks Mesh → Torch: with both open it names both
        board.get("mesh").record_failure()
        board.get("mesh").record_failure()
        hm = sched.submit(PORT.ana.RMSF(u.select_atoms("name CA")),
                          backend="mesh",
                          executor_kwargs={"devices": ["cpu"] * 2},
                          batch_size=8)
        assert sched.drain(timeout=120)
        assert hm.error.breakers == ("mesh", "torch")
        # cooldown over: the probe closes the breaker, the job runs
        t[0] += 31.0
        h2 = sched.submit(PORT.ana.RMSF(u.select_atoms("name CA")),
                          backend="torch",
                          executor_kwargs=PORT.device()[1], batch_size=8)
        assert sched.drain(timeout=120)
        assert h2.error is None and board.get("torch").state == "closed"
        assert board.get("torch").probes == 1
    finally:
        sched.shutdown()


def test_on_card_memory_guard_holds_instead_of_serial(monkeypatch):
    """With ``job_on_card`` true, a unit that would cross the guard
    waits for the in-flight unit to drain and then runs on the device
    route; a unit larger than the guard runs alone.  Nothing is shed to
    serial."""
    monkeypatch.setattr(tscheduler, "job_on_card", lambda job: True)
    u = PORT.universe()
    release = threading.Event()
    started = threading.Event()

    class Gated(PORT.ana.RMSF):
        def _prepare(self):
            started.set()
            assert release.wait(60.0)
            super()._prepare()

    sched = PORT.service.Scheduler(n_workers=2, autostart=False,
                                   mem_guard_bytes=1,
                                   supervision_interval_s=0.02)
    kw = PORT.device()[1]
    h1 = sched.submit(Gated(u.select_atoms("name CA")), backend="torch",
                      executor_kwargs=kw, batch_size=8, coalesce=False,
                      tenant="first")
    h2 = sched.submit(PORT.ana.RMSF(u.select_atoms("name CB")),
                      backend="torch", executor_kwargs=kw, batch_size=8,
                      coalesce=False, tenant="second")
    sched.start()
    try:
        assert started.wait(60.0)
        # the second worker holds its unit: the first is in flight
        assert not h2.wait(0.3)
        release.set()
        assert sched.drain(timeout=120)
    finally:
        release.set()
        sched.shutdown()
    assert h1.error is None and h2.error is None
    assert h1.finished_t <= h2.started_t
    assert sched.telemetry.admission_shed_serial == 0
    oracle = PORT.ana.RMSF(u.select_atoms("name CB")).run(
        backend="torch", device="cpu", batch_size=8).results.rmsf
    np.testing.assert_array_equal(np.asarray(h2.result().results.rmsf),
                                  np.asarray(oracle))


# ---------------------------------------------------------------------------
# journals replay across the packages, both ways
# ---------------------------------------------------------------------------


def _journaled(p: _Pkg, path: str):
    u = p.universe(n_frames=16)
    backend, kw = p.device()
    sched = p.service.Scheduler(n_workers=1, autostart=False,
                                journal=path)
    for i, sel in enumerate(("name CA", "name CB")):
        sched.submit(p.service.AnalysisJob(
            p.ana.RMSF(u.select_atoms(sel)), backend=backend,
            executor_kwargs=kw, batch_size=8, tenant=f"t{i}",
            fingerprint=f"job-{i}"))
    sched.submit(p.service.AnalysisJob(
        p.ana.RMSF(u.select_atoms("name CA")), backend=backend,
        executor_kwargs=kw, batch_size=8, deadline_s=0.0,
        tenant="late", fingerprint="job-late"))
    sched.start()
    assert sched.drain(timeout=120)
    sched.shutdown()


def _replays(path: str) -> list:
    """What each package reads back from ``path``: the job replay, the
    fleet replay and the scheduler's recover view."""
    out = []
    for journal, sched in ((jjournal, JAX.service.Scheduler),
                           (tjournal, PORT.service.Scheduler)):
        rec = sched.recover(path)
        out.append((journal.replay(path), journal.replay_fleet(path),
                    {k: rec[k] for k in ("done", "quarantined",
                                         "pending")}))
    return out


def _strip_times(doc):
    """Replays carry the writer's wall-clock stamps; the records
    compared are the same records, so only those differ by run."""
    doc = copy.deepcopy(doc)
    for rec in doc.get("jobs", doc).values() if isinstance(doc, dict) \
            else ():
        if isinstance(rec, dict):
            rec.pop("t", None)
    return doc


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_written_by_one_package_replays_in_the_other(
        tmp_path, writer):
    path = str(tmp_path / "jobs.jsonl")
    _journaled(JAX if writer == "jax" else PORT, path)
    (jr, jf, jrec), (tr, tf, trec) = _replays(path)
    assert tr == jr and tf == jf and trec == jrec
    assert trec["done"] == {"job-0", "job-1"}
    assert tr["job-late"]["state"] == "expired"
    # and both writers write the same records for the same workload
    other = str(tmp_path / "other.jsonl")
    _journaled(PORT if writer == "jax" else JAX, other)
    assert _strip_times(tjournal.replay(other)) == \
        _strip_times(tjournal.replay(path))


def test_port_batch_resumes_from_a_jax_journal(tmp_path):
    """A journal the JAX package's ``batch --journal`` left behind
    after finishing the first job is resumed by the port's ``batch``:
    the done job is skipped, the other runs."""
    from mdanalysis_mpi_tpu.service.cli import _job_fingerprint

    spec = {"defaults": {"select": "name CA", "batch_size": 8},
            "workers": 1, "cache_mb": 0,
            "jobs": [{"analysis": "rmsf", "tenant": "a"},
                     {"analysis": "rgyr", "tenant": "b"}]}
    path = str(tmp_path / "jobs.jsonl")
    with jjournal.JobJournal(path) as j:
        fp = _job_fingerprint(0, spec["jobs"][0])
        j.record("submit", fp, tenant="a")
        j.record("finish", fp, state="done")
    jobs_file = tmp_path / "jobs.json"
    spec["defaults"]["device"] = "cpu"
    jobs_file.write_text(json.dumps(spec))
    from mdanalysis_mpi_tpu_torch.service.cli import batch_main

    u = PORT.universe(n_frames=16)
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = batch_main([str(jobs_file), "--journal", path], universe=u)
    doc = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0, doc
    assert doc["recovered_skipped"] == 1
    assert [r["state"] for r in doc["jobs"]] == ["done", "done"]
    assert doc["jobs"][0].get("recovered") is True
    assert jjournal.replay(path)[_job_fingerprint(1, spec["jobs"][1])][
        "state"] == "done"


# ---------------------------------------------------------------------------
# the alert engines fire alike
# ---------------------------------------------------------------------------


def _snapshots():
    """A seeded sequence of unified snapshots walking the seed rules'
    metrics through breach and recovery."""
    rng = np.random.default_rng(13)
    shed = corrupt = flips = 0.0
    out = []
    for i in range(40):
        shed += float(rng.integers(0, 3)) if 8 <= i < 20 else 0.0
        corrupt += 1.0 if i == 25 else 0.0
        flips += float(rng.integers(0, 2)) if 10 <= i < 16 else 0.0
        att = 0.4 if 5 <= i < 18 else 1.0
        out.append({
            "mdtpu_slo_attainment": {"type": "gauge", "values": {
                'class="interactive"': att, 'class="batch"': 1.0}},
            "mdtpu_queue_depth": {"type": "gauge", "values": {
                "": float(80 if 12 <= i < 22 else rng.integers(0, 10))}},
            "mdtpu_jobs_shed_total": {"type": "counter", "values": {
                'class="background"': shed}},
            "mdtpu_scrub_corrupt_total": {"type": "counter",
                                          "values": {"": corrupt}},
            "mdtpu_breaker_transitions_total": {"type": "counter",
                                                "values": {"": flips}},
            "mdtpu_stream_snapshot_age_seconds": {"type": "gauge",
                                                  "values": {"": float(
                                                      45 if 30 <= i < 34
                                                      else 1)}},
            "mdtpu_canary_consecutive_failures": {"type": "gauge",
                                                  "values": {"": float(
                                                      3 if 20 <= i < 24
                                                      else 0)}},
        })
    return out


def test_alert_engines_fire_the_same_transitions():
    custom = [{"name": "queue_deep", "kind": "threshold",
               "metric": "mdtpu_queue_depth", "op": ">", "threshold": 5,
               "for_ticks": 2}]
    for rules in (None, custom):
        seq = []
        for mod in (jalerts, talerts):
            eng = mod.AlertEngine(rules=copy.deepcopy(rules),
                                  clock=lambda: 0.0)
            trans = []
            for i, snap in enumerate(_snapshots()):
                trans += eng.evaluate(copy.deepcopy(snap),
                                      now=1000.0 + 15.0 * i)
            seq.append((trans, eng.status()))
        assert seq[0] == seq[1]
        assert any(t["state"] == "firing" for t in seq[1][0])
        assert any(t["state"] == "resolved" for t in seq[1][0])


# ---------------------------------------------------------------------------
# the perf sentinels give the same verdicts
# ---------------------------------------------------------------------------


RECORDS = ("BENCH_r05.json", "BENCH_r07.json", "BENCH_r08.json")


@pytest.mark.parametrize("base,run", [(RECORDS[0], RECORDS[1]),
                                      (RECORDS[1], RECORDS[2]),
                                      (RECORDS[2], RECORDS[2])])
def test_perf_verdicts_equal_jax(tmp_path, base, run):
    """Snapshot a baseline from one committed bench record and diff
    another against it: the library calls and the ``perf`` subcommand
    of each package agree."""
    with open(os.path.join(REPO, base)) as f:
        bdoc = json.load(f)
    with open(os.path.join(REPO, run)) as f:
        rdoc = json.load(f)
    jb, tb = jbaseline.snapshot_baseline(bdoc), \
        tbaseline.snapshot_baseline(bdoc)
    jb.pop("created", None), tb.pop("created", None)
    assert tb == jb
    assert tbaseline.compare(rdoc, jb) == jbaseline.compare(rdoc, jb)
    # the command line, one process a package
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    outs = []
    for pkg in ("mdanalysis_mpi_tpu", "mdanalysis_mpi_tpu_torch"):
        basefile = str(tmp_path / f"{pkg}.base.json")
        subprocess.run([sys.executable, "-m", pkg, "perf", "snapshot",
                        os.path.join(REPO, base), "--out", basefile],
                       cwd=REPO, env=env, check=True, timeout=120,
                       capture_output=True)
        p = subprocess.run([sys.executable, "-m", pkg, "perf", "diff",
                            os.path.join(REPO, run), "--baseline",
                            basefile, "--json"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
        outs.append((p.returncode, json.loads(p.stdout)))
    assert outs[0] == outs[1]
