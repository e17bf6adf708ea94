"""Two real processes joined by ``torch.distributed`` (gloo on the CPU)
run the port's ``MeshExecutor``: each rank stages only its slice of
every global batch on its two CPU shards, and the partials merge across
the ranks by ``all_reduce`` (moments, sums), ``all_gather`` (the RMSD
series) and ring ``send``/``recv`` (the atom-sharded RDF).  The twin
of tests/test_multihost.py.

The children import only the port.  The parent holds rank 0's and rank
1's results (equal: every rank ends with the merged result) to the
serial float64 oracle at tests/test_multihost.py's tolerances, and to
the JAX package's single-process mesh over four virtual CPU devices
with the same global batch (2 ranks × 2 shards × 2 frames): AlignedRMSF
float32 within 1e-4, fused int16 and delta against the JAX package's
generic route at the fused-vs-generic tolerance (5e-4, delta 5e-3),
RMSD within 1e-4, ring g(r) within 1e-5 relative.

Each child has a hard timeout; a rendezvous that starves on a loaded
host is retried once on a fresh port (tests/test_multihost.py's
bounded-retry rule), so the file stays well under a minute.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_FRAMES = 20          # global batch 8 → the third batch is partial and
N_RES = 30             # lands entirely on rank 0 (tail imbalance)
CHILD_TIMEOUT_S = 90

CHILD = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch

torch.set_num_threads(1)
pid = int(sys.argv[1])
from mdanalysis_mpi_tpu_torch.parallel.distributed import initialize, world
initialize(coordinator_address={coord!r}, num_processes=2, process_id=pid,
           device="cpu", timeout_s=60)
assert world() == (pid, 2), world()

from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF, InterRDF, RMSD
from mdanalysis_mpi_tpu_torch.testing import (make_md_universe,
                                              make_protein_universe)

kw = dict(backend="mesh", devices=["cpu"] * 2, batch_size=2)
u = make_protein_universe(n_residues={n_res}, n_frames={n_frames},
                          noise=0.3, seed=11)
a = AlignedRMSF(u, select="name CA").run(**kw)
q = AlignedRMSF(u, select="name CA", engine="fused").run(
    transfer_dtype="int16", **kw)
ud = make_md_universe(n_residues={n_res}, n_frames={n_frames}, seed=7)
dl = AlignedRMSF(ud, select="name CA", engine="fused").run(
    transfer_dtype="delta", **kw)
r = RMSD(u.select_atoms("name CA")).run(**kw)
assert r.results.rmsd.shape == ({n_frames},)
ub = make_protein_universe(n_residues={n_res}, n_frames=4, noise=0.3,
                           seed=11, box=40.0)
ca = ub.select_atoms("name CA")
g = InterRDF(ca, ca, nbins=8, range=(0.0, 10.0), engine="ring").run(**kw)
np.savez({out!r} + f".{{pid}}.npz", rmsf=a.results.rmsf,
         rmsf_i16=q.results.rmsf, rmsf_delta=dl.results.rmsf,
         rmsd=r.results.rmsd, rdf_ring=g.results.rdf)
"""


def _run_pair(tmp_path, out):
    from mdanalysis_mpi_tpu_torch.testing import handoff_port

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    outputs = []
    for attempt in range(2):
        holder, port = handoff_port()
        script = tmp_path / "child.py"
        script.write_text(CHILD.format(repo=REPO, coord=f"127.0.0.1:{port}",
                                       out=out, n_res=N_RES,
                                       n_frames=N_FRAMES))
        holder.close()
        procs = [subprocess.Popen(
            [sys.executable, str(script), str(i)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for i in range(2)]
        outputs, timed_out = [], False
        for p in procs:
            try:
                stdout, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                timed_out = True
                for q in procs:
                    q.kill()
                    q.wait(timeout=10)
                stdout, _ = p.communicate(timeout=10)
            outputs.append(stdout.decode(errors="replace"))
        if not timed_out and all(p.returncode == 0 for p in procs):
            return
        if attempt == 1:
            if timed_out:
                pytest.fail("2-process gloo run timed out on both "
                            "attempts:\n" + outputs[0][-2000:])
            for i, p in enumerate(procs):
                assert p.returncode == 0, (
                    f"rank {i} failed:\n{outputs[i][-3000:]}")


def test_parity_two_ranks_gloo(tmp_path):
    from mdanalysis_mpi_tpu.analysis import AlignedRMSF, InterRDF, RMSD
    from mdanalysis_mpi_tpu.parallel.executors import MeshExecutor
    from mdanalysis_mpi_tpu.testing import (make_md_universe,
                                            make_protein_universe)

    out = str(tmp_path / "results")
    _run_pair(tmp_path, out)
    got = [np.load(f"{out}.{i}.npz") for i in range(2)]
    for key in got[0].files:
        # every rank holds the merged result
        np.testing.assert_array_equal(got[0][key], got[1][key])
    got = got[0]

    def mesh(**kw):
        return MeshExecutor(batch_size=2, devices=jax.devices()[:4], **kw)

    u = make_protein_universe(n_residues=N_RES, n_frames=N_FRAMES,
                              noise=0.3, seed=11)
    s = AlignedRMSF(u, select="name CA").run(backend="serial")
    sr = RMSD(u.select_atoms("name CA")).run(backend="serial")
    np.testing.assert_allclose(got["rmsf"], s.results.rmsf, atol=1e-4)
    np.testing.assert_allclose(got["rmsf_i16"], s.results.rmsf, atol=1e-3)
    np.testing.assert_allclose(got["rmsd"], sr.results.rmsd, atol=1e-4)
    jm = AlignedRMSF(u, select="name CA").run(backend=mesh())
    np.testing.assert_allclose(got["rmsf"], np.asarray(jm.results.rmsf),
                               atol=1e-4)
    jq = AlignedRMSF(u, select="name CA").run(
        backend=mesh(transfer_dtype="int16"))
    np.testing.assert_allclose(got["rmsf_i16"], np.asarray(jq.results.rmsf),
                               atol=5e-4)
    jr = RMSD(u.select_atoms("name CA")).run(backend=mesh())
    np.testing.assert_allclose(got["rmsd"], np.asarray(jr.results.rmsd),
                               atol=1e-4)

    ud = make_md_universe(n_residues=N_RES, n_frames=N_FRAMES, seed=7)
    sdl = AlignedRMSF(ud, select="name CA").run(backend="serial")
    np.testing.assert_allclose(got["rmsf_delta"], sdl.results.rmsf,
                               atol=1e-3)
    jdl = AlignedRMSF(ud, select="name CA").run(
        backend=mesh(transfer_dtype="delta"))
    np.testing.assert_allclose(got["rmsf_delta"],
                               np.asarray(jdl.results.rmsf), atol=5e-3)

    ub = make_protein_universe(n_residues=N_RES, n_frames=4, noise=0.3,
                               seed=11, box=40.0)
    ca = ub.select_atoms("name CA")
    sg = InterRDF(ca, ca, nbins=8, range=(0.0, 10.0)).run(backend="serial")
    np.testing.assert_allclose(got["rdf_ring"], sg.results.rdf, atol=1e-3)
    jg = InterRDF(ca, ca, nbins=8, range=(0.0, 10.0), engine="ring").run(
        backend=mesh())
    np.testing.assert_allclose(got["rdf_ring"], np.asarray(jg.results.rdf),
                               rtol=1e-5)
