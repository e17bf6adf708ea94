"""The port's twin of ``tests/test_usage.py``: the same cases, translated to
the port (``backend="torch"`` with ``device="cpu"`` where the JAX test
runs ``backend="jax"``).

Per-tenant usage metering (obs/usage.py, docs/OBSERVABILITY.md
"Usage metering, exemplars & the synthetic canary").

Differential strategy: the accounting must be EXACT where the paper's
serving story depends on it — a coalesced pass's pro-rata member
charges sum to the pass total (largest-remainder for integer meters),
the jobs meter reconciles one-for-one against the journal's finish
ledger, and the federated snapshot round-trips the ledger losslessly —
while staying a strict no-op outside the serving path (no context →
no charge; metering disabled → resource meters silent, jobs meter
still exact).
"""

import json

import pytest

from mdanalysis_mpi_tpu_torch import obs
from mdanalysis_mpi_tpu_torch.obs import usage
from mdanalysis_mpi_tpu_torch.obs.metrics import (
    MetricsRegistry, to_prometheus, unified_snapshot,
)

pytestmark = pytest.mark.obs


def _ledger():
    """A ledger over its OWN registry — no cross-test pollution of
    the process-global series."""
    led = usage.UsageLedger(MetricsRegistry())
    led.enable()
    return led


# ---------------------------------------------------------------------------
# pro-rata split invariants
# ---------------------------------------------------------------------------

def test_split_amount_int_sums_exactly_largest_remainder():
    # the invariant the coalesced-pass policy stands on: integer
    # shares sum EXACTLY to the total, for every total/weight shape
    for weights in ([1], [1, 1], [3, 3, 1], [5, 3, 1], [7, 2, 2, 2],
                    [1, 99], [0, 0], [2, 0, 5]):
        for total in range(0, 23):
            shares = usage.split_amount(total, weights)
            assert len(shares) == len(weights)
            assert sum(shares) == total, (total, weights, shares)
            assert all(s >= 0 for s in shares)
    # largest remainder: 10 over [3, 3, 1] → raw [4.29, 4.29, 1.43]
    # → floors [4, 4, 1] + 1 to the largest fractional part (.43)
    assert usage.split_amount(10, [3, 3, 1]) == [4, 4, 2]
    # ties break by position (stable): 3 over equal halves → [2, 1]
    assert usage.split_amount(3, [1, 1]) == [2, 1]
    # zero/empty weights degrade to an equal split, never a crash
    assert usage.split_amount(9, [0, 0, 0]) == [3, 3, 3]
    assert usage.split_amount(5, []) == []


def test_split_amount_float_sums_exactly_remainder_to_last():
    for weights in ([2, 1], [5, 3, 1], [1, 99], [7, 7, 7, 7]):
        for total in (0.125, 1.0, 0.123456, 3600.75):
            shares = usage.split_amount(total, weights)
            assert sum(shares) == pytest.approx(total, rel=1e-12)
            # remainder-to-last: the last share absorbs the fp dust
            assert shares[-1] == total - sum(shares[:-1])


def test_charge_split_member_rows_sum_to_pass_totals():
    led = _ledger()
    weights = [("a", "batch", 5), ("b", "batch", 3),
               ("c", "interactive", 1)]
    led.charge_split(weights, frames=9, staged_bytes=(1 << 20) + 7,
                     dispatch_s=0.123456, cache_byte_seconds=77.5)
    rows = led.rows()
    assert set(rows) == {("a", "batch"), ("b", "batch"),
                        ("c", "interactive")}
    # integer meters: EXACT sums (largest remainder)
    assert sum(r["frames"] for r in rows.values()) == 9
    assert sum(r["staged_bytes"] for r in rows.values()) == (1 << 20) + 7
    # float meters: remainder-to-last keeps the sum exact too
    assert sum(r["dispatch_s"] for r in rows.values()) == \
        pytest.approx(0.123456, rel=1e-12)
    assert sum(r["cache_byte_seconds"] for r in rows.values()) == \
        pytest.approx(77.5, rel=1e-12)
    # pro-rata: the 5-frame member carries more than the 1-frame one
    assert rows[("a", "batch")]["frames"] == 5
    assert rows[("c", "interactive")]["frames"] == 1
    assert rows[("a", "batch")]["dispatch_s"] > \
        rows[("c", "interactive")]["dispatch_s"]


# ---------------------------------------------------------------------------
# ledger ↔ snapshot ↔ /usage document round trip
# ---------------------------------------------------------------------------

def test_ledger_round_trips_through_snapshot_and_usage_doc():
    led = _ledger()
    led.charge("alice", "interactive", frames=40, dispatch_s=2.5,
               staged_bytes=4096)
    led.charge("bob", "batch", frames=10, dispatch_s=0.5)
    led.charge_store("alice", "interactive", "remote", chunks=3,
                     nbytes=300)
    led.charge_store("alice", "interactive", "cache", chunks=1,
                     nbytes=100)
    led.charge_job("alice", "interactive", "done")
    led.charge_job("bob", "batch", "shed")
    snap = led.registry.snapshot()
    rows = usage.ledger_from_snapshot(snap)
    # the federated twin reproduces the live rows meter-for-meter
    live = led.rows()
    assert set(rows) == set(live)
    for key, row in live.items():
        for meter, v in row.items():
            assert rows[key][meter] == pytest.approx(v), (key, meter)
    doc = usage.usage_doc(snap)
    assert set(doc["tenants"]) == {"alice", "bob"}
    assert doc["top"] == ["alice", "bob"]          # by dispatch_s
    assert doc["tenants"]["alice"]["frames"] == 40
    assert doc["tenants"]["alice"]["store_chunks[remote]"] == 3
    assert doc["tenants"]["alice"]["store_chunks[cache]"] == 1
    assert doc["tenants"]["alice"]["jobs[done]"] == 1
    assert doc["classes"]["batch"]["jobs[shed]"] == 1
    assert doc["tenants"]["alice"]["classes"]["interactive"][
        "dispatch_s"] == pytest.approx(2.5)
    # the doc is the /usage wire format: JSON-clean
    json.dumps(doc)
    text = usage.render_usage(doc)
    assert "alice" in text and "bob" in text
    assert usage.render_usage(doc, top=1).count("bob") == 0
    # a snapshot with no usage series renders the empty document
    empty = usage.usage_doc(MetricsRegistry().snapshot())
    assert empty == {"tenants": {}, "classes": {}, "top": []}
    assert "(no usage recorded)" in usage.render_usage(empty)


def test_charge_current_requires_serving_context(monkeypatch):
    led = _ledger()
    monkeypatch.setattr(usage, "LEDGER", led)
    # outside the serving path: a strict no-op (direct run() calls
    # cost nothing)
    usage.charge_current(staged_bytes=1 << 30)
    usage.charge_current_store(source="remote", chunks=5, nbytes=500)
    assert led.rows() == {}
    with obs.trace_context(usage_weights=[("a", "batch", 2),
                                          ("b", "batch", 2)]):
        usage.charge_current(staged_bytes=7)
        usage.charge_current_store(source="local", chunks=2,
                                   nbytes=100)
    rows = led.rows()
    # 7 bytes over equal weights: largest remainder → 4 / 3
    assert rows[("a", "batch")]["staged_bytes"] == 4
    assert rows[("b", "batch")]["staged_bytes"] == 3
    assert rows[("a", "batch")]["store_chunks[local]"] == 1
    assert sum(r["store_bytes[local]"] for r in rows.values()) == 100


def test_disabled_metering_skips_resources_jobs_meter_stays_exact():
    led = _ledger()
    led.disable()
    led.charge("t", "batch", frames=5, dispatch_s=1.0)
    led.charge_store("t", "batch", "local", chunks=1, nbytes=10)
    led.charge_split([("t", "batch", 1)], frames=5)
    # the jobs meter is NOT gated: it is the exactly-once meter
    # reconcile() audits against the journal, benched metering off
    # or not
    led.charge_job("t", "batch", "done")
    assert led.rows() == {("t", "batch"): {"jobs[done]": 1}}
    led.enable()
    led.charge("t", "batch", frames=5)
    assert led.rows()[("t", "batch")]["frames"] == 5


# ---------------------------------------------------------------------------
# reconciliation against the journal's finish ledger
# ---------------------------------------------------------------------------

def test_reconcile_exact_diff_and_baseline():
    led = _ledger()
    journal = {"finishes": {"a": 1, "b": 1, "c": 1},
               "jobs": {"a": {"tenant": "t0", "state": "done"},
                        "b": {"tenant": "t1", "state": "failed"},
                        "c": {"state": "done"}}}   # tenant → default
    led.charge_job("t0", "batch", "done")
    led.charge_job("t1", "batch", "failed")
    led.charge_job("default", "batch", "done")
    res = usage.reconcile(led.registry.snapshot(), journal)
    assert res["ok"] is True and res["diff"] == {}
    assert res["journal"] == {"t0/done": 1, "t1/failed": 1,
                              "default/done": 1}
    assert res["usage"] == res["journal"]
    # one phantom charge → the audit names the exact row
    led.charge_job("t0", "batch", "done")
    res = usage.reconcile(led.registry.snapshot(), journal)
    assert res["ok"] is False
    assert res["diff"] == {"t0/done": {"usage": 2, "journal": 1}}
    # a baseline snapshot subtracts PRIOR work: the process served
    # other jobs before this journal opened (the bench) and still
    # reconciles exactly
    base = led.registry.snapshot()
    led.charge_job("t2", "batch", "done")
    res = usage.reconcile(
        led.registry.snapshot(),
        {"finishes": {"x": 1},
         "jobs": {"x": {"tenant": "t2", "state": "done"}}},
        baseline=base)
    assert res["ok"] is True, res["diff"]
    assert res["usage"] == {"t2/done": 1}


# ---------------------------------------------------------------------------
# end-to-end: a served store-backed job charges the real meters
# ---------------------------------------------------------------------------

def test_served_store_job_charges_frames_dispatch_store_and_outcome(
        tmp_path, monkeypatch):
    from mdanalysis_mpi_tpu_torch.analysis import RMSF
    from mdanalysis_mpi_tpu_torch.core.universe import Universe
    from mdanalysis_mpi_tpu_torch.io.store.ingest import ingest
    from mdanalysis_mpi_tpu_torch.io.store.reader import StoreReader
    from mdanalysis_mpi_tpu_torch.service import Scheduler
    from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

    led = _ledger()
    monkeypatch.setattr(usage, "LEDGER", led)
    u = make_protein_universe(n_residues=8, n_frames=6, noise=0.2,
                              seed=3)
    out = str(tmp_path / "store")
    ingest(u.trajectory, out=out)
    su = Universe(u.topology, StoreReader(out))
    sched = Scheduler(n_workers=1, autostart=False)
    h = sched.submit(RMSF(su.select_atoms("name CA")),
                     backend="serial", tenant="acct", coalesce=False)
    sched.start()
    assert sched.drain(timeout=60)
    sched.shutdown()
    assert h.error is None
    row = led.rows()[("acct", "batch")]
    # the serving context stamped the weights; every charge site fed
    # this tenant's row: exact frame count, wall dispatch seconds,
    # store reads attributed to the local rung, one done job
    assert row["frames"] == 6
    assert row["dispatch_s"] > 0
    assert row["store_chunks[local]"] >= 1
    assert row["store_bytes[local]"] > 0
    assert row["jobs[done]"] == 1


# ---------------------------------------------------------------------------
# histogram exemplars (opt-in OpenMetrics rendering)
# ---------------------------------------------------------------------------

def test_histogram_exemplars_snapshot_and_openmetrics_opt_in():
    reg = MetricsRegistry()
    with obs.trace_context(trace_id="job-17"):
        reg.observe("mdtpu_job_latency_seconds", 0.21)
    reg.observe("mdtpu_job_latency_seconds", 0.05)  # no context → none
    snap = reg.snapshot()
    ex = snap["mdtpu_job_latency_seconds"]["values"][""]["exemplars"]
    # keyed by the natural (first-fit) bucket; latest observation wins
    [(le, entry)] = ex.items()
    assert entry == {"trace_id": "job-17", "value": 0.21}
    assert 0.21 <= float(le)
    # exposition: classic Prometheus form by default (scrapers reject
    # the `#` continuation), OpenMetrics exemplar syntax on opt-in
    plain = to_prometheus(snap)
    assert ' # {trace_id=' not in plain
    om = to_prometheus(snap, exemplars=True)
    assert f'le="{le}"' in om
    assert ' # {trace_id="job-17"} 0.21' in om
    # the exemplar survives the unified-snapshot merge the /status
    # and heartbeat-federation paths read
    uni = unified_snapshot(registry=reg)
    assert uni["mdtpu_job_latency_seconds"]["values"][""][
        "exemplars"] == ex


# ---------------------------------------------------------------------------
# the /usage endpoint + the stdlib `mdtpu usage` CLI
# ---------------------------------------------------------------------------

def test_usage_endpoint_and_cli_json_and_human(capsys):
    from mdanalysis_mpi_tpu_torch.service.statusd import (
        StatusServer, fetch_status, usage_main,
    )

    led = _ledger()
    led.charge("alice", "interactive", frames=12, dispatch_s=1.25)
    led.charge_job("alice", "interactive", "done")
    srv = StatusServer(
        lambda: {"role": "test"},
        usage_fn=lambda: usage.usage_doc(led.registry.snapshot()))
    try:
        host, port = srv.address
        doc = fetch_status(f"{host}:{port}", route="/usage")
        assert doc["top"] == ["alice"]
        assert doc["tenants"]["alice"]["frames"] == 12
        # --json prints the raw document
        assert usage_main([f"{host}:{port}", "--json"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["tenants"]["alice"]["jobs[done]"] == 1
        # human table ranks tenants by dispatch seconds
        assert usage_main([f"{host}:{port}", "--top", "5"]) == 0
        text = capsys.readouterr().out
        assert "alice" in text and "dispatch_s" in text
        # the `mdtpu usage` dispatch route reaches the same entry
        # point without importing torch (utils/config.py gate)
        from mdanalysis_mpi_tpu_torch.utils.config import main as cli_main

        assert cli_main(["usage", f"{host}:{port}", "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["top"] == ["alice"]
    finally:
        srv.close()
    # unreachable target: structured error, exit 1, no traceback
    assert usage_main(["127.0.0.1:1", "--timeout", "0.2"]) == 1
    err = json.loads(capsys.readouterr().out)
    assert "error" in err and err["target"] == "127.0.0.1:1"
