"""The port's config layer and command line (``utils/config.py``,
``__main__.py``): the JAX package's tests/test_utils.py config and CLI
cases with the port's backends (``torch`` on ``--device cpu`` for the
JAX package's ``jax``), ``main([...])`` in-process on a small PSF/DCD
whose ``--output`` npz matches the JAX package's CLI on the same files
(serial: equal; the device routes within the JAX package's tolerances),
the subcommands whose modules are not ported yet, and ``python -m
mdanalysis_mpi_tpu_torch`` end to end in a subprocess."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mdanalysis_mpi_tpu_torch.testing import make_protein_universe
from mdanalysis_mpi_tpu_torch.utils import AnalysisConfig, run_config
from mdanalysis_mpi_tpu_torch.utils.config import ANALYSES, main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def psf_dcd(tmp_path_factory):
    """A small protein as PSF + DCD, written by the port (the JAX
    package writes the same bytes, tests/test_torch_io_dcd.py)."""
    from mdanalysis_mpi_tpu_torch.io.dcd import write_dcd
    from mdanalysis_mpi_tpu_torch.io.psf import write_psf

    d = tmp_path_factory.mktemp("cli")
    u = make_protein_universe(n_residues=12, n_frames=9, noise=0.4, seed=4)
    psf, dcd = str(d / "p.psf"), str(d / "p.dcd")
    write_psf(psf, u.topology)
    write_dcd(dcd, u.trajectory.read_block(0, 9)[0])
    return psf, dcd, d


def _run_main(capsys, argv):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


class TestConfig:
    def test_validate_rejects_unknown_analysis(self):
        with pytest.raises(ValueError, match="unknown analysis"):
            AnalysisConfig(analysis="nope", topology="x.gro").validate()

    def test_validate_requires_topology(self):
        with pytest.raises(ValueError, match="topology"):
            AnalysisConfig(analysis="rmsf").validate()

    def test_analyses_table_matches_jax_package(self):
        from mdanalysis_mpi_tpu.utils.config import ANALYSES as J

        assert ANALYSES == J

    def test_run_config_rmsf_matches_direct(self):
        from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF

        u = make_protein_universe(n_residues=6, n_frames=8, seed=1)
        cfg = AnalysisConfig(analysis="aligned-rmsf", topology="mem",
                             select="name CA", backend="serial")
        a = run_config(cfg, universe=u)
        direct = AlignedRMSF(u, select="name CA").run(backend="serial")
        np.testing.assert_allclose(
            a.results.rmsf, direct.results.rmsf, atol=1e-12)
        d = run_config(AnalysisConfig(analysis="aligned-rmsf",
                                      topology="mem", select="name CA",
                                      device="cpu"), universe=u)
        np.testing.assert_allclose(d.results.rmsf, direct.results.rmsf,
                                   atol=1e-3)

    def test_run_config_rdf(self):
        from mdanalysis_mpi_tpu_torch.testing import make_water_universe

        u = make_water_universe(n_waters=30, n_frames=3, seed=2)
        cfg = AnalysisConfig(analysis="rdf", topology="mem",
                             select="name OW", nbins=20, r_max=8.0,
                             backend="serial")
        a = run_config(cfg, universe=u)
        assert a.results.bins.shape == (20,)

    @pytest.mark.parametrize("backend", ["serial", "torch", "mesh"])
    @pytest.mark.parametrize("analysis,select,key,extra", [
        ("pca", "name CA", "p_components", {"align": True,
                                            "n_components": 3}),
        ("msd", "name CA", "timeseries", {"msd_type": "xy"}),
        ("ramachandran", "protein", "angles", {}),
        ("density", "name CA", "grid", {"delta": 2.0}),
        ("rgyr", "name CA", "rgyr", {}),
        ("pairwise-distances", "name CA", "distances", {}),
    ])
    def test_run_config_every_analysis(self, analysis, select, key, extra,
                                       backend):
        """Every CLI-reachable analysis builds and runs through the
        config layer with a non-empty keyed result, on each backend."""
        u = make_protein_universe(n_residues=6, n_frames=8, seed=1)
        cfg = AnalysisConfig(analysis=analysis, topology="mem",
                             select=select, backend=backend,
                             device=None if backend == "serial" else "cpu",
                             **extra)
        a = run_config(cfg, universe=u)
        v = np.asarray(getattr(a.results, key))
        assert v.size > 0
        assert np.isfinite(v).all()

    def test_default_backend_is_torch_on_cuda(self):
        """No backend named: the analysis' default, ``torch`` on
        ``cuda`` (the JAX package's CLI takes ``serial``)."""
        import torch

        assert AnalysisConfig().backend is None
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        u = make_protein_universe(n_residues=4, n_frames=4, seed=1)
        cfg = AnalysisConfig(analysis="rgyr", topology="mem",
                             select="name CA")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_config(cfg, universe=u)


class TestRound5CLIAnalyses:
    def test_helanal_gnm_via_config(self):
        u = make_protein_universe(n_residues=8, n_frames=6, seed=2)
        a = run_config(AnalysisConfig(analysis="helanal", topology="mem",
                                      select="name CA",
                                      backend="serial"), universe=u)
        assert np.isfinite(np.asarray(a.results.local_twists)).all()
        g = run_config(AnalysisConfig(analysis="gnm", topology="mem",
                                      select="name CA", cutoff=15.0,
                                      backend="serial"), universe=u)
        assert np.isfinite(np.asarray(g.results.eigenvalues)).all()

    def test_wor_lineardensity_via_config(self):
        from mdanalysis_mpi_tpu_torch.testing import make_water_universe

        u = make_water_universe(n_waters=20, n_frames=6, seed=3)
        a = run_config(AnalysisConfig(analysis="wor", topology="mem",
                                      select="name OW", dtmax=3,
                                      backend="serial"), universe=u)
        assert np.asarray(a.results.timeseries).shape == (4, 3)
        d = run_config(AnalysisConfig(analysis="wor", topology="mem",
                                      select="name OW", dtmax=3,
                                      device="cpu"), universe=u)
        np.testing.assert_allclose(d.results.timeseries,
                                   a.results.timeseries, atol=1e-5)
        u.add_TopologyAttr("charges")
        ld = run_config(AnalysisConfig(analysis="lineardensity",
                                       topology="mem", select="name OW",
                                       binsize=1.0, backend="serial"),
                        universe=u)
        assert np.asarray(ld.results.x.mass_density).size > 0

    def test_janin_via_config(self):
        from mdanalysis_mpi_tpu_torch.core.topology import Topology
        from mdanalysis_mpi_tpu_torch.core.universe import Universe
        from mdanalysis_mpi_tpu_torch.io.memory import MemoryReader

        names = np.array(["N", "CA", "CB", "CG", "CD"] * 2)
        top = Topology(names=names, resnames=np.full(10, "LYS"),
                       resids=np.repeat([1, 2], 5))
        rng = np.random.default_rng(4)
        u = Universe(top, MemoryReader(
            rng.normal(scale=3.0, size=(2, 10, 3)).astype(np.float32)))
        a = run_config(AnalysisConfig(analysis="janin", topology="mem",
                                      select="protein",
                                      backend="serial"), universe=u)
        ang = np.asarray(a.results.angles)
        assert ang.shape == (2, 2, 2)
        assert ((0 <= ang) & (ang < 360)).all()


class TestWaterbridgeCLI:
    def test_waterbridge_via_config(self):
        """The waterbridge CLI path: config -> analysis -> npz-able
        bridge_counts series; with no backend named it takes its own
        default, serial."""
        from tests.test_torch_waterbridge import _bridge_universe

        u = _bridge_universe(n_frames=3)
        for backend in ("serial", None):
            cfg = AnalysisConfig(analysis="waterbridge", topology="mem",
                                 select="resname PROT",
                                 select2="resname ACCP", backend=backend)
            a = run_config(cfg, universe=u)
            counts = np.asarray(a.results.bridge_counts)
            assert counts.shape == (3,)
            assert (counts == 1).all()

    def test_waterbridge_requires_select2(self):
        from tests.test_torch_waterbridge import _bridge_universe

        cfg = AnalysisConfig(analysis="waterbridge", topology="mem",
                             select="resname PROT", backend="serial")
        with pytest.raises(ValueError, match="select2"):
            run_config(cfg, universe=_bridge_universe())


class TestMainInProcess:
    """``main([...])`` on the PSF/DCD against the JAX package's CLI on
    the same files."""

    def _jax_npz(self, argv, out):
        from mdanalysis_mpi_tpu.utils.config import main as jmain

        assert jmain(argv + ["--output", out]) == 0
        return np.load(out)

    @pytest.mark.parametrize("analysis,key,port_kw,jax_kw,tol", [
        ("aligned-rmsf", "rmsf", ["--device", "cpu"], ["--backend", "jax"],
         1e-5),
        ("aligned-rmsf", "rmsf", ["--backend", "serial"],
         ["--backend", "serial"], 0.0),
        ("rmsd", "rmsd", ["--device", "cpu", "--transfer-dtype", "int16"],
         ["--backend", "jax", "--transfer-dtype", "int16"], 1e-3),
        ("rgyr", "rgyr", ["--backend", "mesh", "--device", "cpu"],
         ["--backend", "mesh"], 1e-5),
        ("gnm", "eigenvalues", ["--backend", "serial"],
         ["--backend", "serial"], 0.0),
    ])
    def test_npz_matches_jax_package_cli(self, capsys, psf_dcd, analysis,
                                         key, port_kw, jax_kw, tol):
        psf, dcd, d = psf_dcd
        base = [analysis, psf, dcd, "--select", "name CA",
                "--batch-size", "4"]
        out = str(d / f"port-{analysis}-{len(port_kw)}.npz")
        summary = _run_main(capsys, base + port_kw + ["--output", out])
        assert summary["n_frames"] == 9 and summary["output"] == out
        assert "phases" in summary
        want = self._jax_npz(base + jax_kw,
                             str(d / f"jax-{analysis}-{len(port_kw)}.npz"))
        capsys.readouterr()
        got = np.load(out)
        assert sorted(got.files) == sorted(want.files)
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol)

    def test_summary_names_the_backend(self, capsys, psf_dcd):
        psf, dcd, _ = psf_dcd
        s = _run_main(capsys, ["rgyr", psf, dcd, "--device", "cpu"])
        assert s["backend"] == "torch" and s["device"] == "cpu"
        s = _run_main(capsys, ["rgyr", psf, dcd, "--backend", "serial"])
        assert s["backend"] == "serial"

    def test_trace_out_writes_spans(self, capsys, psf_dcd):
        psf, dcd, d = psf_dcd
        path = str(d / "spans.json")
        s = _run_main(capsys, ["rgyr", psf, dcd, "--device", "cpu",
                               "--trace-out", path])
        assert s["trace_out"] == path
        with open(path) as f:
            assert "traceEvents" in json.load(f)
        from mdanalysis_mpi_tpu_torch import obs

        obs.disable_tracing()

    def test_jax_backend_name_refused(self, psf_dcd):
        psf, dcd, _ = psf_dcd
        with pytest.raises(SystemExit):
            main(["rgyr", psf, dcd, "--backend", "jax"])

    @pytest.mark.parametrize("sub,label", [("lint", "MDT111")])
    def test_subcommands_not_ported_yet(self, sub, label, capsys):
        """Every subcommand of the JAX package's CLI is ported: ``lint``
        reaches the port's checker (its rule catalog lists the capture
        contracts)."""
        assert main([sub, "--list-rules"]) == 0
        assert label in capsys.readouterr().out

    @pytest.mark.parametrize("sub", ["batch", "status", "usage", "perf",
                                     "fleet", "fleet-host"])
    def test_serving_subcommands_dispatch(self, sub, capsys):
        """The serving, fleet and observability subcommands reach the
        port's own entry points (their parsers answer ``--help``)."""
        with pytest.raises(SystemExit) as exc:
            main([sub, "--help"])
        assert exc.value.code == 0
        assert f"mdanalysis_mpi_tpu_torch {sub}" in capsys.readouterr().out

    def test_ingest_subcommand(self, capsys, tmp_path):
        from mdanalysis_mpi_tpu_torch import Universe
        from mdanalysis_mpi_tpu_torch.io.xtc import write_xtc

        u = make_protein_universe(n_residues=5, n_frames=6, seed=7)
        xtc, store = str(tmp_path / "t.xtc"), str(tmp_path / "store")
        write_xtc(xtc, u.trajectory.read_block(0, 6)[0])
        assert main(["ingest", xtc, "--out", store]) == 0
        capsys.readouterr()
        frames, _ = Universe(u.topology, store).trajectory.read_block(0, 6)
        assert frames.shape == (6, u.atoms.n_atoms, 3)


class TestCLI:
    def test_end_to_end_on_files(self, tmp_path):
        """Write a GRO+XTC fixture, run ``python -m
        mdanalysis_mpi_tpu_torch``, check the npz output."""
        from mdanalysis_mpi_tpu_torch.io.gro import write_gro
        from mdanalysis_mpi_tpu_torch.io.xtc import write_xtc

        u = make_protein_universe(n_residues=5, n_frames=7, seed=4)
        n = u.trajectory.n_frames
        coords = np.stack([u.trajectory[i].positions for i in range(n)])
        gro = str(tmp_path / "top.gro")
        xtc = str(tmp_path / "traj.xtc")
        out = str(tmp_path / "out.npz")
        write_gro(gro, u.topology, coords[0])
        write_xtc(xtc, coords)

        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run(
            [sys.executable, "-m", "mdanalysis_mpi_tpu_torch",
             "aligned-rmsf", gro, xtc, "--select", "name CA", "--device",
             "cpu", "--output", out],
            capture_output=True, text=True, env=env, cwd=str(tmp_path),
            timeout=240)
        assert proc.returncode == 0, proc.stderr
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        assert summary["n_frames"] == 7
        assert summary["backend"] == "torch"
        assert "phases" in summary
        data = np.load(out)
        assert data["rmsf"].shape == (5,)
        assert np.isfinite(data["rmsf"]).all()
