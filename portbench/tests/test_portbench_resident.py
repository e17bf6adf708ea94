"""The ``resident`` source: its run is correct and its window stages
nothing, a cache that cannot hold the run or that loses its blocks
after the fill is refused, and the cells call the program exactly as
before, the resident source only adding its one cache."""

import json

import pytest

from portbench import harness
from portbench.tests._tiny import RESIDENT, TINY, listed, plant, run_cpu

#: the staging phases' shares, which a resident window never reads
STAGING = {"stage_share.rmsf", "stage_wait_share.rmsf", "gather_share.rmsf",
           "repack_share.rmsf", "chunk_read_share.rmsf", "wire_share.rmsf"}

#: records every call of the program's analyses' ``run``, one JSON line
#: a call: the keyword names and values (an object by its type and id)
RECORD = """
    import json, os
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF, InterRDF

    def _plain(v):
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        return [type(v).__name__, id(v)]

    def _wrap(cls):
        run = cls.run

        def recorded(self, *args, **kwargs):
            with open(os.environ["RECORD_TO"], "a") as f:
                f.write(json.dumps({"cls": cls.__name__, "args": len(args),
                                    "kw": {k: _plain(v) for k, v
                                           in kwargs.items()}}) + "\\n")
            return run(self, *args, **kwargs)

        cls.run = recorded

    _wrap(AlignedRMSF)
    _wrap(InterRDF)
"""

#: each old cell's call of the program, as the harness has always made
#: it: the warm-up (a prefix) first, then the window's whole analyses
OLD_CALLS = {
    "rmsf_heavy_100k.memory": (
        "AlignedRMSF", {"backend": "torch", "device": "cpu",
                        "batch_size": 256, "transfer_dtype": "int16"}),
    "rmsf_heavy_100k.store": (
        "AlignedRMSF", {"backend": "torch", "device": "cpu",
                        "batch_size": 256, "transfer_dtype": "int16"}),
    "rdf_oo_32k.memory": (
        "InterRDF", {"backend": "torch", "device": "cpu",
                     "batch_size": 8}),
    "rmsf_heavy_100k_4rank.memory": (
        "AlignedRMSF", {"backend": ["MeshExecutor", None]}),
}


def _calls(tmp_path, cell, sizes):
    out = tmp_path / "calls.jsonl"
    rc, result, err = run_cpu(cell, sizes, env=dict(
        plant(tmp_path, RECORD), RECORD_TO=str(out)))
    assert rc == 0, err[-3000:]
    assert result["correct"], result["checks"]
    return [json.loads(ln) for ln in out.read_text().splitlines()]


@pytest.mark.parametrize("cell", sorted(OLD_CALLS))
def test_old_cells_call_the_program_as_before(tmp_path, cell):
    cls, kw = OLD_CALLS[cell]
    calls = _calls(tmp_path, cell, TINY[cell])
    warmup = TINY[cell]["config"]["warmup_frames"]
    assert calls and all(c["cls"] == cls and c["args"] == 0 for c in calls)
    for i, c in enumerate(calls):
        got = dict(c["kw"])
        if kw["backend"] == ["MeshExecutor", None]:
            # one executor object a call, made afresh
            got["backend"] = [got["backend"][0], None]
        # the ranks' warm-ups and windows interleave in the record
        stops = ({warmup, None} if "4rank" in cell
                 else {warmup if i == 0 else None})
        assert got.pop("stop") in stops, (i, c)
        assert got == kw, (i, c)


def test_resident_source_adds_one_cache_to_the_memory_cells_call(
        tmp_path):
    calls = _calls(tmp_path, *RESIDENT)
    memory = OLD_CALLS["rmsf_heavy_100k.memory"][1]
    caches = {tuple(c["kw"]["block_cache"]) for c in calls}
    assert len(caches) == 1 and next(iter(caches))[0] == "DeviceBlockCache"
    # the fill and the window: whole analyses, never a prefix
    assert len(calls) >= 3
    for c in calls:
        got = dict(c["kw"])
        del got["block_cache"]
        assert got == dict(memory, stop=None), c


def test_resident_traced_run_is_correct_and_reads_no_staging():
    cell, sizes = RESIDENT
    rc, result, err = run_cpu(cell, sizes, trace=1)
    assert rc == 0, err[-3000:]
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    # the memory cell's metrics less the staging shares and, with no
    # card, the device roofline
    assert set(result["metrics"]) == (listed(cell) - STAGING
                                      - {"device_roofline.rmsf"})
    for name in ("pass1_share.rmsf", "dispatch_share.rmsf"):
        assert 0 < result["metrics"][name]["value"] <= 100


def test_a_cache_that_cannot_hold_the_run_is_refused():
    cell, sizes = RESIDENT
    sizes = dict(sizes, traffic=dict(sizes["traffic"], cache_bytes=1))
    rc, result, err = run_cpu(cell, sizes)
    assert rc != 0 and result is None
    assert "NotResident" in err and "cannot hold the run" in err


def test_a_window_that_stages_is_refused(tmp_path):
    # the cache is emptied once the fill has settled
    drop = """
        import portbench.harness as h
        import portbench.sources.resident as r

        _fill, _universe = h.fill, r.Source.universe
        filled = []

        def fill(*args, **kwargs):
            _fill(*args, **kwargs)
            filled.append(True)

        def universe(self):
            if filled:
                self._cache.drop()
            return _universe(self)

        h.fill = fill
        r.Source.universe = universe
    """
    rc, result, err = run_cpu(*RESIDENT, env=plant(tmp_path, drop))
    assert rc != 0 and result is None
    assert "NotResident" in err and "window analyses staged" in err


@pytest.mark.parametrize("phases,refused", [
    ([{"pass1": {}, "pass2": {}, "dispatch": {}}] * 3, False),
    ([{"pass1": {}}, {"pass1": {}, "wire": {}}], True),
    ([{"pass1": {}, "gather": {}, "stage": {}}], True),
])
def test_the_window_check_reads_the_staging_phases(phases, refused):
    if refused:
        with pytest.raises(harness.NotResident):
            harness.check_resident_window(phases, harness.graph_captures())
    else:
        harness.check_resident_window(phases, harness.graph_captures())
