"""Config dataclass + CLI (SURVEY.md §5.6; the JAX package's
``utils/config.py``).

The reference hardcodes everything — files (RMSF.py:34,56), reference
frame (63), selection (77), partition policy (66-69) — and takes no
arguments.  The framework exposes those knobs as a dataclass and a thin
CLI: ``python -m mdanalysis_mpi_tpu_torch rmsf top.gro traj.xtc
--select "protein and name CA" --backend torch``.

The port's entry points run on the card, so with no ``--backend`` an
analysis runs on its own default backend, ``torch`` on ``cuda`` (the
JAX package's CLI defaults to ``serial``), but for the serial-only
``waterbridge``; ``--device cpu`` runs the device route on the CPU and
``--backend serial`` the float64 oracle.  ``ingest`` is the block
store's command; ``batch`` runs a JSON job file through the serving
scheduler (``service/cli.py``), ``status`` and ``usage`` fetch a
running scheduler's endpoint, and ``perf`` is the perf-regression
sentinel (``obs/baseline.py``).  ``fleet`` serves a job file across N
host processes (``service/fleet.py``; ``fleet-host`` is one such host,
spawned by the controller), each on the card unless ``--device`` says
otherwise.  ``lint`` (ROADMAP A11) is not ported yet and raises
``NotImplementedError``.

Output (Q7 — the reference computes the RMSF then drops it,
RMSF.py:146-147): results are written as ``.npz`` when ``--output`` is
given, and a one-line JSON summary (result shapes, frames/sec, phase
timer report) always goes to stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ANALYSES = ("rmsf", "aligned-rmsf", "rmsd", "average-structure", "rdf",
            "contacts", "pairwise-distances", "rgyr", "pca", "msd",
            "ramachandran", "density", "janin", "helanal",
            "lineardensity", "gnm", "wor", "waterbridge")


@dataclasses.dataclass
class AnalysisConfig:
    """Everything the reference hardcodes, as data."""

    analysis: str = "aligned-rmsf"
    topology: str = ""
    trajectory: str | list | None = None   # several files chain into one
    select: str = "protein and name CA"
    select2: str | None = None          # rdf second group (defaults to select)
    start: int | None = None
    stop: int | None = None
    step: int | None = None
    ref_frame: int = 0                  # RMSF.py:63
    backend: str | None = None          # None: the analysis' default
    device: str | None = None           # torch/mesh: None → cuda
    batch_size: int | None = None
    transfer_dtype: str = "float32"
    nbins: int = 75                     # rdf
    r_max: float = 15.0                 # rdf range upper edge
    engine: str = "auto"                # rdf histogram engine; "fused":
    #                                     aligned-rmsf's fused kernel
    cutoff: float = 8.0                 # contacts
    align: bool = False                 # pca: superpose onto the mean
    n_components: int | None = None     # pca
    msd_type: str = "xyz"               # msd dimensions
    delta: float = 1.0                  # density grid spacing (Å)
    dtmax: int = 20                     # wor lag window
    gnm_cutoff: float = 7.0             # gnm contact cutoff (upstream default)
    binsize: float = 0.25               # lineardensity slab thickness (Å)
    wb_order: int = 1                   # waterbridge: max waters in a chain
    wb_distance: float = 3.0            # waterbridge donor-acceptor cutoff
    wb_angle: float = 120.0             # waterbridge D-H-A angle cutoff
    water: str | None = None            # waterbridge water selection
    output: str | None = None

    def validate(self) -> None:
        if self.analysis not in ANALYSES:
            raise ValueError(
                f"unknown analysis {self.analysis!r}; available: {ANALYSES}")
        if not self.topology:
            raise ValueError("a topology file is required")


def build_analysis(cfg: AnalysisConfig, universe=None):
    """Config → constructed (not yet run) analysis object."""
    from mdanalysis_mpi_tpu_torch import Universe, analysis as ana

    cfg.validate()
    u = universe if universe is not None else Universe(
        cfg.topology, cfg.trajectory)
    if cfg.analysis == "rmsf":
        return ana.RMSF(u.select_atoms(cfg.select))
    if cfg.analysis == "aligned-rmsf":
        # engine "fused": the hand kernel's route on int16/int8/delta
        # staging; any other engine value is the generic route
        return ana.AlignedRMSF(
            u, select=cfg.select, ref_frame=cfg.ref_frame,
            engine="fused" if cfg.engine == "fused" else None)
    if cfg.analysis == "rmsd":
        return ana.RMSD(u, select=cfg.select, ref_frame=cfg.ref_frame)
    if cfg.analysis == "average-structure":
        return ana.AverageStructure(u, select=cfg.select,
                                    ref_frame=cfg.ref_frame)
    if cfg.analysis == "rdf":
        g1 = u.select_atoms(cfg.select)
        g2 = u.select_atoms(cfg.select2 or cfg.select)
        return ana.InterRDF(g1, g2, nbins=cfg.nbins, range=(0.0, cfg.r_max),
                            engine=cfg.engine)
    if cfg.analysis == "contacts":
        return ana.ContactMap(u.select_atoms(cfg.select), cutoff=cfg.cutoff)
    if cfg.analysis == "pairwise-distances":
        return ana.PairwiseDistances(u.select_atoms(cfg.select))
    if cfg.analysis == "rgyr":
        return ana.RadiusOfGyration(u.select_atoms(cfg.select))
    if cfg.analysis == "pca":
        return ana.PCA(u, select=cfg.select, align=cfg.align,
                       ref_frame=cfg.ref_frame,
                       n_components=cfg.n_components)
    if cfg.analysis == "msd":
        return ana.EinsteinMSD(u, select=cfg.select, msd_type=cfg.msd_type)
    if cfg.analysis == "ramachandran":
        return ana.Ramachandran(u.select_atoms(cfg.select))
    if cfg.analysis == "density":
        return ana.DensityAnalysis(u.select_atoms(cfg.select),
                                   delta=cfg.delta)
    if cfg.analysis == "janin":
        return ana.Janin(u.select_atoms(cfg.select))
    if cfg.analysis == "helanal":
        return ana.HELANAL(u, select=cfg.select)
    if cfg.analysis == "lineardensity":
        return ana.LinearDensity(u.select_atoms(cfg.select),
                                 binsize=cfg.binsize)
    if cfg.analysis == "gnm":
        # NOT cfg.cutoff (the contacts knob, default 8.0) — GNM keeps
        # its own upstream default of 7.0
        return ana.GNMAnalysis(u, select=cfg.select,
                               cutoff=cfg.gnm_cutoff)
    if cfg.analysis == "waterbridge":
        if not cfg.select2:
            raise ValueError(
                "waterbridge needs --select2 (the second terminal "
                "selection)")
        return ana.WaterBridgeAnalysis(
            u, cfg.select, cfg.select2, water_selection=cfg.water,
            order=cfg.wb_order, distance=cfg.wb_distance,
            angle=cfg.wb_angle)
    if cfg.analysis == "wor":
        return ana.WaterOrientationalRelaxation(u, select=cfg.select,
                                                dtmax=cfg.dtmax)
    raise AssertionError(cfg.analysis)


def run_config(cfg: AnalysisConfig, universe=None):
    """Build + run per config; returns the finished analysis object."""
    a = build_analysis(cfg, universe=universe)
    backend = cfg.backend or a._default_backend
    kwargs = {}
    if backend in ("torch", "mesh") and cfg.batch_size is not None:
        kwargs["batch_size"] = cfg.batch_size
    if backend in ("torch", "mesh") and cfg.transfer_dtype != "float32":
        kwargs["transfer_dtype"] = cfg.transfer_dtype
    if backend == "torch" and cfg.device is not None:
        kwargs["device"] = cfg.device
    if backend == "mesh" and cfg.device is not None:
        kwargs["devices"] = [cfg.device]
    return a.run(start=cfg.start, stop=cfg.stop, step=cfg.step,
                 backend=backend, **kwargs)


#: subcommands of the JAX package's CLI whose modules the port lacks yet
_NOT_PORTED = {
    "lint": "the lint tooling, ROADMAP A11",
}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mdanalysis_mpi_tpu_torch",
        description="GPU trajectory analysis in PyTorch "
                    "(RMSF/RMSD/RDF/distances over pluggable backends)",
        epilog="`python -m mdanalysis_mpi_tpu_torch ingest TRAJ --out "
               "DIR` writes a block store (docs/STORE.md).")
    p.add_argument("analysis", choices=ANALYSES)
    p.add_argument("topology", help="GRO/PSF/PDB/PQR/MOL2/CRD/PRMTOP/ITP/PDBQT/TXYZ topology file")
    p.add_argument("trajectory", nargs="*", default=None,
                   help="XTC/DCD/TRR/NetCDF/XYZ/LAMMPS-dump/mdcrd/INPCRD trajectory file(s) — several files "
                        "chain into one (restart segments); omit for "
                        "topology coords")
    p.add_argument("--select", default="protein and name CA")
    p.add_argument("--select2", default=None,
                   help="second selection (rdf's B group; waterbridge's "
                        "required second terminal)")
    p.add_argument("--start", type=int, default=None)
    p.add_argument("--stop", type=int, default=None)
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--ref-frame", type=int, default=0)
    p.add_argument("--backend", default=None,
                   choices=("serial", "torch", "mesh"),
                   help="default: the analysis' own, torch (on --device) "
                        "but for the serial-only waterbridge")
    p.add_argument("--device", default=None,
                   help="device of the torch/mesh backends (default "
                        "cuda; 'cpu' runs the device route on the CPU)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--transfer-dtype", default="float32",
                   choices=("float32", "int16", "int8", "delta"))
    p.add_argument("--nbins", type=int, default=75)
    p.add_argument("--engine", default="auto",
                   choices=("auto", "xla", "pallas", "ring", "fused"),
                   help="RDF histogram engine (ring needs --backend "
                        "mesh); 'fused' runs aligned-rmsf's fused kernel "
                        "(with --transfer-dtype int16/int8/delta)")
    p.add_argument("--r-max", type=float, default=15.0)
    p.add_argument("--cutoff", type=float, default=8.0)
    p.add_argument("--align", action="store_true",
                   help="PCA: superpose frames onto the run-average "
                        "structure before fitting")
    p.add_argument("--n-components", type=int, default=None)
    p.add_argument("--msd-type", default="xyz",
                   choices=("xyz", "xy", "xz", "yz", "x", "y", "z"))
    p.add_argument("--delta", type=float, default=1.0,
                   help="density grid spacing in Å")
    p.add_argument("--dtmax", type=int, default=20,
                   help="wor: maximum lag (analyzed-frame steps)")
    p.add_argument("--gnm-cutoff", type=float, default=7.0,
                   help="gnm: Kirchhoff contact cutoff in Å")
    p.add_argument("--binsize", type=float, default=0.25,
                   help="lineardensity slab thickness in Å")
    p.add_argument("--wb-order", type=int, default=1,
                   help="waterbridge: max waters in a bridge chain")
    p.add_argument("--wb-distance", type=float, default=3.0,
                   help="waterbridge donor-acceptor cutoff (A)")
    p.add_argument("--wb-angle", type=float, default=120.0,
                   help="waterbridge D-H-A angle cutoff (deg)")
    p.add_argument("--water", default=None,
                   help="waterbridge water selection override")
    p.add_argument("--output", default=None, help="write results to .npz")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace (Chrome trace "
                        "JSON, DIR/trace.json) of the run to DIR")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="write a Chrome trace-event JSON of the run's "
                        "spans to FILE (open in Perfetto / "
                        "chrome://tracing; env twin MDTPU_TRACE_OUT — "
                        "docs/OBSERVABILITY.md)")
    return p


def main(argv=None) -> int:
    from mdanalysis_mpi_tpu_torch.utils.timers import TIMERS

    args = sys.argv[1:] if argv is None else list(argv)
    if args and args[0] == "batch":
        # multi-tenant job-file mode (service/ subsystem): N analyses,
        # one scheduler, request coalescing
        from mdanalysis_mpi_tpu_torch.service.cli import batch_main

        return batch_main(args[1:])
    if args and args[0] == "fleet":
        # controller tier: a job file across N host worker processes
        # (sticky placement, host-loss migration, epoch fencing)
        from mdanalysis_mpi_tpu_torch.service.fleet import fleet_main

        return fleet_main(args[1:])
    if args and args[0] == "fleet-host":
        # internal: one fleet host worker (spawned by
        # FleetController.spawn_host; not an operator surface)
        from mdanalysis_mpi_tpu_torch.service.fleet import host_main

        return host_main(args[1:])
    if args and args[0] == "status":
        # one-shot fetch of /status from a running scheduler endpoint:
        # stdlib sockets only
        from mdanalysis_mpi_tpu_torch.service.statusd import status_main

        return status_main(args[1:])
    if args and args[0] == "usage":
        # one-shot fetch of /usage (per-tenant usage meters)
        from mdanalysis_mpi_tpu_torch.service.statusd import usage_main

        return usage_main(args[1:])
    if args and args[0] == "perf":
        # perf-regression sentinel over bench records: a pure JSON
        # compare
        from mdanalysis_mpi_tpu_torch.obs.baseline import perf_main

        return perf_main(args[1:])
    if args and args[0] == "ingest":
        # block-store ingest (io/store subsystem): one decode pass
        # re-chunks a trajectory into the random-access quantized
        # store — docs/STORE.md.  A host decode pass, no device.
        from mdanalysis_mpi_tpu_torch.io.store.cli import ingest_main

        return ingest_main(args[1:])
    if args and args[0] in _NOT_PORTED:
        raise NotImplementedError(
            f"the {args[0]!r} subcommand is not ported yet "
            f"({_NOT_PORTED[args[0]]})")
    ns = _parser().parse_args(args)
    cfg = AnalysisConfig(
        analysis=ns.analysis, topology=ns.topology,
        trajectory=(None if not ns.trajectory
                    else ns.trajectory[0] if len(ns.trajectory) == 1
                    else ns.trajectory),
        select=ns.select, select2=ns.select2, start=ns.start, stop=ns.stop,
        step=ns.step, ref_frame=ns.ref_frame, backend=ns.backend,
        device=ns.device, batch_size=ns.batch_size,
        transfer_dtype=ns.transfer_dtype,
        nbins=ns.nbins, r_max=ns.r_max, cutoff=ns.cutoff, output=ns.output,
        engine=ns.engine, align=ns.align, n_components=ns.n_components,
        msd_type=ns.msd_type, delta=ns.delta, dtmax=ns.dtmax,
        binsize=ns.binsize, gnm_cutoff=ns.gnm_cutoff,
        wb_order=ns.wb_order, wb_distance=ns.wb_distance,
        wb_angle=ns.wb_angle, water=ns.water)
    from mdanalysis_mpi_tpu_torch import obs
    from mdanalysis_mpi_tpu_torch.utils.timers import device_trace

    trace_out = ns.trace_out or os.environ.get("MDTPU_TRACE_OUT")
    if trace_out:
        obs.enable_tracing(trace_out)
    TIMERS.reset()
    t0 = time.perf_counter()
    with device_trace(ns.trace or os.environ.get("MDTPU_TRACE")):
        a = run_config(cfg)
        # force deferred finalizers + device fetches (also surfaces
        # deferred validation errors) before filtering for serializable
        # arrays — inside the timed window so wall_s stays an honest
        # end-to-end number
        a.results.materialize()
    wall = time.perf_counter() - t0
    if trace_out:
        obs.export_trace(trace_out)
    arrays = {}
    for k, v in a.results.items():
        if isinstance(v, (list, tuple)) and any(
                hasattr(x, "shape") for x in v):
            # containers of arrays (e.g. the per-axis `edges` list) are
            # excluded CONSISTENTLY — for some shapes np.asarray would
            # succeed and for others not, which would make the npz key
            # set depend on the data; such results carry homogeneous
            # per-key twins (edges_x/y/z) instead
            continue
        if not (isinstance(v, (np.ndarray, list, tuple, float, int))
                or hasattr(v, "shape")):
            continue
        try:
            arr = np.asarray(v)
        except ValueError:
            # ragged nested results (waterbridge's per-frame bridge
            # chains, whose count varies frame to frame) are not
            # npz-able; their flat summaries (bridge_counts) are
            continue
        if arr.dtype == object:     # same raggedness, older numpy path
            continue
        arrays[k] = arr
    if cfg.output:
        np.savez(cfg.output, **arrays)
    print(json.dumps({
        "analysis": cfg.analysis,
        "backend": cfg.backend or a._default_backend,
        "device": cfg.device,
        "n_frames": a.n_frames, "wall_s": round(wall, 4),
        "frames_per_sec": round(a.n_frames / wall, 2) if wall > 0 else None,
        "results": {k: list(v.shape) for k, v in arrays.items()},
        "output": cfg.output, "phases": TIMERS.report(),
        "trace_out": trace_out,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
