"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package (``mdanalysis_mpi_tpu``), runs on ``cuda`` unless told
otherwise, and refuses to fall back to the CPU silently.

Name checks compare exact module names: ``mdanalysis_mpi_tpu_torch``
starts with ``mdanalysis_mpi_tpu``, so a bare prefix test would flag
the port itself.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mdanalysis_mpi_tpu_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _is_forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "jaxlib" or name.startswith("jaxlib.")
            or name == "mdanalysis_mpi_tpu"
            or name.startswith("mdanalysis_mpi_tpu."))


def test_forbidden_name_check_is_exact():
    assert _is_forbidden("mdanalysis_mpi_tpu.ops.align")
    assert _is_forbidden("jax.numpy")
    assert not _is_forbidden("mdanalysis_mpi_tpu_torch")
    assert not _is_forbidden("mdanalysis_mpi_tpu_torch.ops.align")
    assert not _is_forbidden("jaxtyping_like")


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield SMOKE


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import_statement(path):
    """Every import statement, lazy ones inside functions included."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _is_forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


_DRIVE = r"""
import sys
import numpy as np
from mdanalysis_mpi_tpu_torch import Universe
from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF
from mdanalysis_mpi_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mdanalysis_mpi_tpu_torch.testing import make_protein_universe

u = make_protein_universe(n_residues=8, n_frames=12)
u2 = Universe(u.topology, u.trajectory.read_block(0, 12)[0])
ca = u2.select_atoms("name CA")
q, boxes, inv = u2.trajectory.stage_block(0, 8, ca.indices, "int16",
                                           layout="planar")
assert q.shape == (3, 8, ca.n_atoms) and q.dtype == np.int16
r = AlignedRMSF(u2, select="name CA", engine="fused").run(
    backend="torch", device="cpu", batch_size=8, transfer_dtype="int16")
assert np.isfinite(r.results.rmsf).all()
# the RDF slice on the CPU: the kernel route runs the kernel's plain
# version, and nothing of JAX is imported on the way
from mdanalysis_mpi_tpu_torch.analysis import (ContactMap, InterRDF,
                                               InterRDF_s, PairwiseDistances)
from mdanalysis_mpi_tpu_torch.ops import distances, fused_distances
from mdanalysis_mpi_tpu_torch.testing import make_water_universe
uw = make_water_universe(n_waters=27, n_frames=4, box=9.3)
ow = uw.select_atoms("name OW")
g = InterRDF(ow, ow, nbins=12, range=(0.0, 4.5), engine="pallas").run(
    backend="torch", device="cpu", batch_size=2)
assert np.isfinite(g.results.rdf).all() and g.results.count.sum() > 0
# the RMSD / I/O slice: a PSF/DCD pair, RMSD, AlignTraj streamed to a
# DCD, Contacts and AtomicDistances
import os, tempfile
from mdanalysis_mpi_tpu_torch.analysis import (RMSD, AlignTraj,
                                               AtomicDistances, Contacts)
from mdanalysis_mpi_tpu_torch.io.dcd import write_dcd
from mdanalysis_mpi_tpu_torch.io.psf import write_psf
tmp = tempfile.mkdtemp()
write_psf(os.path.join(tmp, "p.psf"), u.topology)
write_dcd(os.path.join(tmp, "p.dcd"), u.trajectory.read_block(0, 12)[0])
up = Universe(os.path.join(tmp, "p.psf"), [os.path.join(tmp, "p.dcd")] * 2)
rd = RMSD(up, select="name CA", groupselections=["name CB"]).run(
    device="cpu", batch_size=8)
assert rd.results.rmsd.shape == (24,) and rd.results.group_rmsd.shape == (24, 1)
at = AlignTraj(up, select="name CA", in_memory=False,
               filename=os.path.join(tmp, "fit.dcd")).run(device="cpu")
assert at.results.universe.trajectory.n_frames == 24
cb = up.select_atoms("name CB")
ct = Contacts(up, select=("name CA", "name CB"),
              refgroup=(up.select_atoms("name CA"), cb), radius=6.0).run(
    device="cpu", batch_size=8)
assert ct.results.timeseries.shape == (24, 2)
ad = AtomicDistances(up.select_atoms("name CA"), cb).run(device="cpu")
assert ad.results.distances.shape == (24, 8)
# the store slice: ingest the DCD into an int16 block store, open it
# as a Universe, run the fused engine from it, and load every module of
# the store, obs, utils and breaker packages
import importlib, pkgutil
from mdanalysis_mpi_tpu_torch import obs, utils
from mdanalysis_mpi_tpu_torch.io import store
from mdanalysis_mpi_tpu_torch.reliability import breaker
for pkg in (obs, utils, store):
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(pkg.__name__ + "." + m.name)
store_dir = os.path.join(tmp, "p.store")
summary = store.ingest(os.path.join(tmp, "p.dcd"), store_dir,
                       chunk_frames=8, quant="int16")
assert summary["n_chunks"] == 2
us = Universe(u.topology, store_dir)
assert isinstance(us.trajectory, store.StoreReader)
rs = AlignedRMSF(us, select="name CA", engine="fused").run(
    backend="torch", device="cpu", batch_size=8, transfer_dtype="int16")
assert np.isfinite(rs.results.rmsf).all() and set(us.trajectory._f32) <= {0}
assert obs.METRICS.snapshot()["mdtpu_fused_blocks_total"]["values"]
# the streaming and multi-device slice: every new module imports, the
# mesh (fused int16, four CPU shards), the ring RDF, the MPI executor
# over an in-process communicator, the dry run and a streamed RMSF
# from a follow store run, and mpi4py is not imported on the way
from mdanalysis_mpi_tpu_torch import parallel
for m in pkgutil.iter_modules(parallel.__path__):
    importlib.import_module(parallel.__name__ + "." + m.name)
import mdanalysis_mpi_tpu_torch.ops.ring
from mdanalysis_mpi_tpu_torch.parallel.dryrun import dryrun_multichip
from mdanalysis_mpi_tpu_torch.parallel.mpi import MPIExecutor, ThreadComm
from mdanalysis_mpi_tpu_torch.analysis import RMSF
rm = AlignedRMSF(u2, select="name CA", engine="fused").run(
    backend="mesh", devices=["cpu"] * 4, batch_size=2,
    transfer_dtype="int16")
assert np.abs(rm.results.rmsf - r.results.rmsf).max() < 1e-3
gr = InterRDF(ow, ow, nbins=12, range=(0.0, 4.5), engine="ring").run(
    backend="mesh", devices=["cpu"] * 2, batch_size=2)
np.testing.assert_allclose(gr.results.count, g.results.count)
rmpi = RMSF(ca).run(backend=MPIExecutor(comm=ThreadComm.make(1)[0]))
assert np.isfinite(rmpi.results.rmsf).all()
assert set(dryrun_multichip(2, device="cpu")) >= {"float32", "ring_rdf"}
rst = RMSF(Universe(u.topology, store.StoreReader(store_dir, follow=True))
           .select_atoms("name CA")).run_streaming(device="cpu")
assert [sn["frames"] for sn in rst.results.stream_snapshots] == [8, 12]
# the scan-folding, checkpoint and reliability slice: every module of
# the reliability package imports; a folded cached repeat, a resilient
# run, a checkpointed two-pass run and the mesh with scan_k, prestage
# and reliability, all without JAX
from mdanalysis_mpi_tpu_torch import reliability
for m in pkgutil.iter_modules(reliability.__path__):
    importlib.import_module(reliability.__name__ + "." + m.name)
from mdanalysis_mpi_tpu_torch.parallel.executors import (
    DeviceBlockCache, MeshExecutor, warmup_analysis)
from mdanalysis_mpi_tpu_torch.reliability import (ReliabilityPolicy,
                                                  ReliabilityRuntime)
from mdanalysis_mpi_tpu_torch.utils.checkpoint import run_checkpointed
cache = DeviceBlockCache()
for _ in range(2):
    rf = AlignedRMSF(u2, select="name CA", engine="fused").run(
        backend="torch", device="cpu", batch_size=4,
        transfer_dtype="int16", block_cache=cache, scan_k="auto")
assert any("scan" in k for k in cache._store)
rr = RMSD(up, select="name CA").run(backend="serial", resilient=True)
assert rr.results.reliability["fallbacks"] == []
ck = AlignedRMSF(u2, select="name CA")
run_checkpointed(ck, chunk_frames=8, backend="torch", device="cpu",
                 batch_size=4, checkpoint_dir=tmp)
assert np.isfinite(ck.results.rmsf).all()
mx = MeshExecutor(devices=["cpu"] * 2, batch_size=2, scan_k=2,
                  prestage=True,
                  reliability=ReliabilityRuntime(ReliabilityPolicy()),
                  block_cache=DeviceBlockCache())
assert np.isfinite(RMSF(ca).run(backend=mx).results.rmsf).all()
assert warmup_analysis(AlignedRMSF(u2, select="name CA"), mx) > 0
# the serving slice: every module of the service package imports, and
# a served fused job runs through the scheduler with its journal
from mdanalysis_mpi_tpu_torch import service
for m in pkgutil.iter_modules(service.__path__):
    importlib.import_module(service.__name__ + "." + m.name)
sched = service.Scheduler(n_workers=1, autostart=False,
                          cache=DeviceBlockCache(),
                          journal=os.path.join(tmp, "jobs.jsonl"))
hs = sched.submit(AlignedRMSF(u2, select="name CA", engine="fused"),
                  backend="torch", batch_size=4,
                  executor_kwargs={"device": "cpu",
                                   "transfer_dtype": "int16"})
sched.start()
assert sched.drain(timeout=120)
sched.shutdown()
assert np.isfinite(hs.result().results.rmsf).all()
assert service.Scheduler.recover(os.path.join(tmp, "jobs.jsonl"))["done"]
assert "mpi4py" not in sys.modules
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "mdanalysis_mpi_tpu")
             or m.startswith(("jax.", "jaxlib.", "mdanalysis_mpi_tpu.")))
assert not bad, bad
assert DEFAULT_DEVICE == "cuda"
import torch
from mdanalysis_mpi_tpu_torch.analysis import AverageStructure, RMSF
if not torch.cuda.is_available():
    # a bare run() is the torch backend on the default device
    for call in (lambda: resolve_device(),
                 lambda: AlignedRMSF(u2, select="name CA").run(
                     backend="torch", batch_size=8),
                 lambda: AlignedRMSF(u2, select="name CA").run(),
                 lambda: AverageStructure(u2, select="name CA").run(),
                 lambda: RMSF(ca).run(),
                 lambda: InterRDF(ow, ow).run(),
                 lambda: InterRDF_s(uw, [(ow[:2], ow[2:4])]).run(),
                 lambda: ContactMap(ow).run(),
                 lambda: PairwiseDistances(ow).run(),
                 lambda: RMSD(up).run(),
                 lambda: AlignTraj(up).run(),
                 lambda: Contacts(up, select=("name CA", "name CB"),
                                  refgroup=(up.select_atoms("name CA"), cb),
                                  radius=6.0).run(),
                 lambda: AtomicDistances(up.select_atoms("name CA"),
                                         cb).run(),
                 lambda: RMSF(ca).run(backend="mesh"),
                 lambda: RMSF(ca).run_streaming(),
                 lambda: service.AnalysisJob(RMSF(ca)).analysis.run(
                     backend=service.AnalysisJob(RMSF(ca)).backend),
                 lambda: dryrun_multichip(2),
                 lambda: service.FleetController(
                     os.path.join(tmp, "fleet"), status=False)):
        try:
            call()
        except RuntimeError as exc:
            assert "no CUDA device" in str(exc), exc
        else:
            raise AssertionError("ran without a GPU and without device='cpu'")
print("ISOLATED")
"""


def test_mpi4py_is_imported_only_inside_world_comm():
    """``parallel/mpi.py`` imports mpi4py lazily, in ``_world_comm``
    alone, so the module imports where mpi4py is not installed."""
    path = os.path.join(PKG, "parallel", "mpi.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    sites = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import)
                         else [node.module or ""])
                if any(n.split(".")[0] == "mpi4py" for n in names):
                    sites.append(fn.name)
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))
           and "mpi4py" in ast.dump(n)]
    assert not top and sites == ["_world_comm"], (top, sites)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return env


def test_port_runs_without_jax_in_a_fresh_process():
    p = subprocess.run([sys.executable, "-c", _DRIVE], cwd=REPO,
                       env=_env(), capture_output=True, text=True,
                       timeout=240)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "ISOLATED" in p.stdout


_FLEET = r"""
import json, sys
from mdanalysis_mpi_tpu_torch.service import fleet
rc = fleet.fleet_main(["--smoke", "--device", "cpu"])
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "mdanalysis_mpi_tpu")
             or m.startswith(("jax.", "jaxlib.", "mdanalysis_mpi_tpu.")))
print("RC", rc, "BAD", bad)
"""


def test_fleet_smoke_runs_without_jax_in_a_fresh_process():
    """The fleet's dryrun smoke on the CPU (two port hosts, a ``kill
    -9``, the QoS, ensemble and streaming phases) passes in a fresh
    process that imports nothing of JAX; its hosts are port processes
    by construction (``python -m mdanalysis_mpi_tpu_torch
    fleet-host``)."""
    env = _env()
    env["OMP_NUM_THREADS"] = "1"
    p = subprocess.run([sys.executable, "-c", _FLEET], cwd=REPO,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "RC 0 BAD []" in p.stdout, p.stdout + p.stderr[-3000:]
    record = json.loads(p.stdout.splitlines()[0])
    assert record["ok"] and record["exactly_once"]


_SMOKE_NO_GPU = r"""
import sys
sys.argv = ["chip_smoke.py"]
import chip_smoke
rc = chip_smoke.main()
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "mdanalysis_mpi_tpu")
             or m.startswith(("jax.", "jaxlib.", "mdanalysis_mpi_tpu.")))
print("RC", rc, "BAD", bad)
"""


def test_chip_smoke_fails_without_a_gpu():
    """Here there is no card: the smoke script exits non-zero, prints no
    ok line, and imported nothing of JAX on the way."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present; chip_smoke.py would run for real")
    p = subprocess.run([sys.executable, "-c", _SMOKE_NO_GPU], cwd=REPO,
                       env=_env(), capture_output=True, text=True,
                       timeout=240)
    assert p.returncode == 0, p.stderr
    assert "RC 1 BAD []" in p.stdout
    assert '"ok"' not in p.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script exits non-zero and prints no result."""
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=240)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
