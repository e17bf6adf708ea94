"""A dry run of the mesh executor: one data-parallel AlignedRMSF step
over ``n_devices`` device shards, checked against the serial float64
oracle (the port's twin of the repository's ``dryrun_multichip``).

Run it on the CPU with four shards::

    python -c "from mdanalysis_mpi_tpu_torch.parallel.dryrun import \\
dryrun_multichip; print(dryrun_multichip(4, device='cpu'))"
"""

from __future__ import annotations

import numpy as np


def _shard_devices(n_devices: int, device) -> list:
    """``n_devices`` shard devices: ``device`` repeated, or with no
    device the visible CUDA cards in turn (a card holds several shards
    when there are fewer cards than shards)."""
    import torch

    from mdanalysis_mpi_tpu_torch.device import resolve_device

    if device is not None:
        return [resolve_device(device)] * n_devices
    resolve_device(None)              # raises without a card
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run AlignedRMSF (both passes, the moment merge across the shards)
    on a small protein-like system over ``n_devices`` shards with
    float32 staging, the fused engine on int16 staging, and the delta
    wire on a correlated trajectory; then the RMSD series and the ring
    RDF over the same shards.  Each is held to the serial float64
    oracle: RMSF, RMSD within 1e-3 Å, g(r) within 1e-2.  Returns the
    largest differences by leg; raises AssertionError on a divergence.
    """
    from mdanalysis_mpi_tpu_torch.analysis import (AlignedRMSF, InterRDF,
                                                   RMSD)
    from mdanalysis_mpi_tpu_torch.parallel.executors import MeshExecutor
    from mdanalysis_mpi_tpu_torch.testing import (make_md_universe,
                                                  make_protein_universe,
                                                  make_water_universe)

    devices = _shard_devices(n_devices, device)
    sel = "protein and name CA"

    def mesh(**kw):
        return MeshExecutor(batch_size=2, devices=devices, **kw)

    def worst(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max())

    errs = {}
    u = make_protein_universe(n_residues=6, n_frames=4 * n_devices,
                              noise=0.2, seed=0)
    s = AlignedRMSF(u, select=sel).run(backend="serial")
    r = AlignedRMSF(u, select=sel).run(backend=mesh())
    assert r.results.rmsf.shape == (6,), r.results.rmsf.shape
    assert np.isfinite(r.results.rmsf).all(), "non-finite RMSF"
    errs["float32"] = worst(r.results.rmsf, s.results.rmsf)
    fu = AlignedRMSF(u, select=sel, engine="fused").run(
        backend=mesh(transfer_dtype="int16"))
    errs["fused_int16"] = worst(fu.results.rmsf, s.results.rmsf)
    ud = make_md_universe(n_residues=12, n_frames=4 * n_devices, seed=5)
    sdl = AlignedRMSF(ud, select="name CA").run(backend="serial")
    dl = AlignedRMSF(ud, select="name CA", engine="fused").run(
        backend=mesh(transfer_dtype="delta"))
    errs["fused_delta"] = worst(dl.results.rmsf, sdl.results.rmsf)
    ca = u.select_atoms(sel)
    errs["rmsd"] = worst(RMSD(ca).run(backend=mesh()).results.rmsd,
                         RMSD(ca).run(backend="serial").results.rmsd)
    for leg in ("float32", "fused_int16", "fused_delta", "rmsd"):
        assert errs[leg] < 1e-3, f"mesh {leg} vs serial divergence " \
            f"{errs[leg]}"
    w = make_water_universe(n_waters=32, n_frames=2 * n_devices)
    ow = w.select_atoms("name OW")
    ring = InterRDF(ow, ow, nbins=16, range=(0.0, 6.0),
                    engine="ring").run(backend=mesh())
    serial = InterRDF(ow, ow, nbins=16, range=(0.0, 6.0)).run(
        backend="serial")
    errs["ring_rdf"] = worst(ring.results.rdf, serial.results.rdf)
    assert errs["ring_rdf"] < 1e-2, \
        f"ring vs serial RDF divergence {errs['ring_rdf']}"
    return errs
