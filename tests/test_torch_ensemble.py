"""The port's twin of ``tests/test_ensemble.py``: the same cases on the
port's ``service/ensemble.py``, ``io/store/parallel.py`` and ``ingest``
CLI, plus parity with the JAX package on the same seeded NumPy inputs
(``expand_ensemble`` and ``member_store`` equal, ``merge_member_results``
within 1e-12).

Ensemble scale-out units (docs/ENSEMBLE.md): spec expansion, the pooled
Welford / pairwise-RMSD / RDF reductions against one-pass oracles, the
thread-pooled CAS ingest driver with its cross-member hardlink dedup,
and the ``ingest --jobs N`` CLI surface.  The fleet-integrated paths
live in tests/test_torch_fleet*.py.
"""

import json
import os

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.service.ensemble import (
    EnsembleSpecError, expand_ensemble, member_store, merge_member_results,
    merge_moments, merge_rdf, pairwise_rmsd,
)


class TestExpandEnsemble:
    BASE = {"analysis": "rmsf", "tenant": "t",
            "fixture": {"kind": "protein", "n_residues": 4}}

    def test_int_count_seeds_distinct_members(self):
        members = expand_ensemble(dict(self.BASE, ensemble=3))
        assert len(members) == 3
        # distinct per-member seeds: a replica ensemble of one
        # UNSEEDED fixture would otherwise be N identical universes
        assert [m["fixture"]["seed"] for m in members] == [0, 1, 2]
        assert all(m["fixture"]["n_residues"] == 4 for m in members)
        assert all("ensemble" not in m and "ingest" not in m
                   for m in members)

    def test_int_count_respects_pinned_seed(self):
        spec = dict(self.BASE, ensemble=2)
        spec["fixture"] = {"kind": "protein", "seed": 9}
        members = expand_ensemble(spec)
        # the base pinned a seed: a deliberate replica-pair ensemble
        assert [m["fixture"]["seed"] for m in members] == [9, 9]

    def test_override_list_merges_fixture_dictwise(self):
        members = expand_ensemble(dict(
            self.BASE,
            ensemble=[{"fixture": {"seed": 7}},
                      {"trajectory": "/data/m1.xtc"}]))
        assert members[0]["fixture"] == {"kind": "protein",
                                         "n_residues": 4, "seed": 7}
        assert members[1]["trajectory"] == "/data/m1.xtc"
        assert members[1]["fixture"] == self.BASE["fixture"]

    def test_members_inherit_parent_qos_unconditionally(self):
        members = expand_ensemble(dict(
            self.BASE, qos="batch",
            ensemble=[{}, {"qos": "interactive"}]))
        # one logical job, one class: a member override must not
        # smuggle a higher class in (docs/ENSEMBLE.md "QoS
        # accounting")
        assert [m["qos"] for m in members] == ["batch", "batch"]
        members = expand_ensemble(dict(
            self.BASE, ensemble=[{}, {"qos": "interactive"}]))
        assert all("qos" not in m for m in members)

    @pytest.mark.parametrize("ens", [None, True, 1, 0, "2",
                                     [{"a": 1}], [{}, "x"]])
    def test_malformed_blocks_rejected_typed(self, ens):
        with pytest.raises(EnsembleSpecError):
            expand_ensemble(dict(self.BASE, ensemble=ens))

    def test_shards_mutually_exclusive(self):
        with pytest.raises(EnsembleSpecError, match="shards"):
            expand_ensemble(dict(self.BASE, ensemble=2, shards=2))

    def test_member_store_is_canonical_member_dir(self):
        from mdanalysis_mpi_tpu_torch.io.store.parallel import member_dir

        assert member_store("/r", 3) == member_dir("/r", 3)
        assert member_store("/r", 3).endswith("m0003")


class TestReductions:
    def test_merge_moments_equals_one_pass_oracle(self):
        rng = np.random.default_rng(3)
        # UNEQUAL member lengths: the weighted merge must pool
        # exactly, not average the averages
        blocks = [rng.normal(size=(n, 5, 3)) for n in (4, 9, 17)]
        carries = []
        for x in blocks:
            mu = x.mean(axis=0)
            carries.append({"mean": mu,
                            "m2": ((x - mu) ** 2).sum(axis=0),
                            "n_frames": float(len(x))})
        got = merge_moments(carries)
        allx = np.concatenate(blocks, axis=0)
        mu = allx.mean(axis=0)
        m2 = ((allx - mu) ** 2).sum(axis=0)
        assert got["n_frames"] == float(len(allx))
        np.testing.assert_allclose(got["mean"], mu, atol=1e-12)
        np.testing.assert_allclose(got["m2"], m2, atol=1e-9)
        np.testing.assert_allclose(
            got["rmsf"],
            np.sqrt(m2.sum(axis=-1) / len(allx)), atol=1e-12)

    def test_pairwise_rmsd_matrix(self):
        a = np.zeros((4, 3))
        b = np.ones((4, 3))
        d = pairwise_rmsd([a, b, a])
        assert d.shape == (3, 3)
        np.testing.assert_allclose(d, d.T)
        np.testing.assert_allclose(np.diag(d), 0.0)
        assert d[0, 2] == 0.0                     # replica pair
        np.testing.assert_allclose(d[0, 1], np.sqrt(3.0))

    def test_merge_rdf_frame_weighted(self):
        bins = np.array([0.5, 1.5])
        m = [{"bins": bins, "edges": np.array([0.0, 1, 2]),
              "count": np.array([2.0, 4.0]),
              "rdf": np.array([1.0, 2.0])},
             {"bins": bins, "edges": np.array([0.0, 1, 2]),
              "count": np.array([1.0, 1.0]),
              "rdf": np.array([3.0, 6.0])}]
        got = merge_rdf(m, weights=[3.0, 1.0])
        np.testing.assert_allclose(got["count"], [3.0, 5.0])
        # g(r) is per-frame intensive: frame-weighted mean
        np.testing.assert_allclose(got["rdf"], [1.5, 3.0])
        m[1]["bins"] = bins + 1.0
        with pytest.raises(ValueError, match="bins"):
            merge_rdf(m, weights=[1.0, 1.0])

    def test_merge_member_results_fanout_and_reductions(self):
        rng = np.random.default_rng(5)
        members = []
        for i in range(3):
            x = rng.normal(size=(6, 4, 3))
            mu = x.mean(axis=0)
            members.append((i, {"analysis": "rmsf"},
                            {"mean": mu.tolist(),
                             "m2": ((x - mu) ** 2).sum(axis=0).tolist(),
                             "n_frames": 6.0,
                             "rmsf": [1.0 * i] * 4}))
        merged = merge_member_results(members)
        assert merged["ensemble_members"] == 3
        assert merged["n_frames"] == 18.0
        assert merged["member2_rmsf"] == [2.0] * 4
        assert np.asarray(merged["pairwise_rmsd"]).shape == (3, 3)
        assert isinstance(merged["rmsf"], list)   # JSON-friendly
        # non-moment results fan out but reduce nothing
        plain = merge_member_results(
            [(0, {}, {"rmsd": [1.0]}), (1, {}, {"rmsd": [2.0]})])
        assert plain["member1_rmsd"] == [2.0]
        assert "rmsf" not in plain and "pairwise_rmsd" not in plain


def _write_members(tmp_path, n_members=4, n_frames=8, n_atoms=30,
                   replica=(2, 3)):
    from mdanalysis_mpi_tpu_torch.io.xtc import write_xtc

    rng = np.random.default_rng(11)
    xtcs, all_frames = [], []
    for i in range(n_members):
        if i == replica[1]:
            frames = all_frames[replica[0]]
        else:
            frames = rng.normal(scale=5.0,
                                size=(n_frames, n_atoms, 3)) \
                .astype(np.float32)
        all_frames.append(frames)
        path = os.path.join(str(tmp_path), f"m{i}.xtc")
        write_xtc(path, frames,
                  dimensions=np.array([40.0, 40, 40, 90, 90, 90]),
                  times=np.arange(n_frames, dtype=np.float32))
        xtcs.append(path)
    return xtcs, all_frames


class TestIngestMany:
    def test_replica_dedup_and_independent_readers(self, tmp_path):
        from mdanalysis_mpi_tpu_torch.io.store import StoreReader
        from mdanalysis_mpi_tpu_torch.io.store.parallel import (
            POOL_DIR, ingest_many, member_dir,
        )

        xtcs, frames = _write_members(tmp_path)
        root = os.path.join(str(tmp_path), "root")
        # jobs=1: members ingest in order, so the replica member's
        # dedup is deterministic — every chunk links against its
        # twin's pool entries
        s = ingest_many(xtcs, root, jobs=1, chunk_frames=4,
                        quant="f32")
        assert s["ok"] and s["n_members"] == 4
        assert s["jobs"] == 1 and s["members_failed"] == 0
        per = s["members"]
        assert [m["member"] for m in per] == [0, 1, 2, 3]
        assert per[3]["dedup_ratio"] == 1.0
        assert per[3]["dedup_chunks"] == per[2]["n_chunks"] == 2
        assert s["dedup_chunks"] == 2
        # aggregate ratio ~ 1/4 of the byte volume (zlib sizes vary
        # slightly per member)
        assert 0.15 < s["dedup_ratio"] < 0.35
        # the dedup is REAL sharing: twin chunks are one inode,
        # through the pool
        m2d, m3d = member_dir(root, 2), member_dir(root, 3)
        cas = sorted(f for f in os.listdir(m3d)
                     if f.startswith("cas-"))
        assert len(cas) == 2
        for name in cas:
            ino = os.stat(os.path.join(m3d, name)).st_ino
            assert os.stat(os.path.join(m2d, name)).st_ino == ino
            assert os.stat(os.path.join(
                root, POOL_DIR, name)).st_ino == ino
        # ...and each member dir is a complete store on its own:
        # f32 passthrough is bit-identical to the XTC decode (the
        # XTC itself quantizes at ~1e-3 Å, so compare to its reader,
        # not the raw arrays)
        from mdanalysis_mpi_tpu_torch.io.xtc import XTCReader

        got, _ = StoreReader(m3d).read_block(0, 8)
        ref, _ = XTCReader(xtcs[3]).read_block(0, 8)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_allclose(got, frames[3], atol=5e-3)

    def test_idempotent_rerun_and_force(self, tmp_path):
        from mdanalysis_mpi_tpu_torch.io.store.parallel import ingest_many

        xtcs, _ = _write_members(tmp_path)
        root = os.path.join(str(tmp_path), "root")
        first = ingest_many(xtcs, root, jobs=2, chunk_frames=4,
                            quant="f32")
        assert first["ok"] and first["members_already"] == 0
        again = ingest_many(xtcs, root, jobs=2, chunk_frames=4,
                            quant="f32")
        # idempotent per member: existing verified stores ARE the
        # answer — no bytes move, disclosed rather than guessed
        assert again["ok"] and again["members_already"] == 4
        assert again["bytes"] == 0 and again["dedup_ratio"] == 0.0
        assert all(m["already_ingested"] for m in again["members"])
        forced = ingest_many(xtcs, root, jobs=1, chunk_frames=4,
                             quant="f32", force=True)
        assert forced["ok"] and forced["members_already"] == 0
        assert forced["bytes"] > 0

    def test_member_failure_isolated(self, tmp_path):
        from mdanalysis_mpi_tpu_torch.io.store.parallel import ingest_many

        xtcs, _ = _write_members(tmp_path, n_members=3,
                                 replica=(0, 1))
        bogus = os.path.join(str(tmp_path), "missing.xtc")
        s = ingest_many([xtcs[0], bogus, xtcs[2]],
                        os.path.join(str(tmp_path), "root"),
                        jobs=3, chunk_frames=4)
        assert s["ok"] is False and s["members_failed"] == 1
        assert "error" in s["members"][1]
        assert "error" not in s["members"][0]
        assert s["members"][2].get("n_chunks") == 2

    def test_empty_input_rejected(self, tmp_path):
        from mdanalysis_mpi_tpu_torch.io.store.parallel import ingest_many

        with pytest.raises(ValueError):
            ingest_many([], str(tmp_path / "root"))


class TestIngestCLI:
    def test_parallel_ingest_jobs_flag(self, tmp_path, capsys):
        from mdanalysis_mpi_tpu_torch.io.store.cli import ingest_main

        xtcs, _ = _write_members(tmp_path)
        root = os.path.join(str(tmp_path), "root")
        rc = ingest_main(xtcs + ["--out-root", root, "--jobs", "1",
                                 "--chunk-frames", "4",
                                 "--quant", "f32"])
        summary = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert summary["n_members"] == 4 and summary["ok"]
        assert summary["dedup_chunks"] == 2
        assert len(summary["members"]) == 4
        # idempotent re-run through the same surface
        rc = ingest_main(xtcs + ["--out-root", root])
        summary = json.loads(capsys.readouterr().out)
        assert rc == 0 and summary["members_already"] == 4

    def test_usage_errors_are_typed_json(self, tmp_path, capsys):
        from mdanalysis_mpi_tpu_torch.io.store.cli import ingest_main

        # --out-root without trajectories
        rc = ingest_main(["--out-root", str(tmp_path / "r")])
        assert rc == 2
        assert "error" in json.loads(capsys.readouterr().out)
        # several trajectories without --out-root
        rc = ingest_main(["a.xtc", "b.xtc"])
        assert rc == 2
        assert "error" in json.loads(capsys.readouterr().out)
        # a failing member propagates rc 1 with the summary intact
        rc = ingest_main(["missing1.xtc", "missing2.xtc",
                          "--out-root", str(tmp_path / "r")])
        summary = json.loads(capsys.readouterr().out)
        assert rc == 1 and summary["members_failed"] == 2


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

class TestParityWithJax:
    @pytest.fixture(autouse=True)
    def _jax(self):
        pytest.importorskip("jax")
        from mdanalysis_mpi_tpu.service import ensemble as jens

        self.jens = jens

    @pytest.mark.parametrize("ens", [
        3, [{"fixture": {"seed": 7}}, {"trajectory": "/d/m1.xtc"}],
        [{}, {"qos": "interactive", "stop": 8}]])
    def test_expand_ensemble_equal(self, ens):
        for base in (TestExpandEnsemble.BASE,
                     dict(TestExpandEnsemble.BASE, qos="batch")):
            spec = dict(base, ensemble=ens)
            assert expand_ensemble(dict(spec)) \
                == self.jens.expand_ensemble(dict(spec))

    def test_member_store_equal(self):
        for i in (0, 3, 12, 9999):
            assert member_store("/r/x", i) == \
                self.jens.member_store("/r/x", i)

    def test_merge_member_results_equal(self):
        rng = np.random.default_rng(21)
        members = []
        for i in range(4):
            n = 3 + 2 * i
            x = rng.normal(size=(n, 7, 3))
            mu = x.mean(axis=0)
            res = {"mean": mu.tolist(),
                   "m2": ((x - mu) ** 2).sum(axis=0).tolist(),
                   "n_frames": float(n),
                   "rmsf": rng.normal(size=7).tolist(),
                   "bins": [0.5, 1.5, 2.5],
                   "edges": [0.0, 1.0, 2.0, 3.0],
                   "count": rng.integers(0, 50, size=3).tolist(),
                   "rdf": rng.uniform(size=3).tolist()}
            members.append((i, {"analysis": "rmsf", "stop": n}, res))
        got = merge_member_results(members)
        want = self.jens.merge_member_results(members)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(want[k], np.float64),
                                       rtol=0, atol=1e-12, err_msg=k)
