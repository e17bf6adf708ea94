"""``AlignedRMSF(u, select, engine).run(...)``: both passes, from
staging to the fused kernel (and, over several ranks, the merge of the
partial sums)."""

from __future__ import annotations

from portbench import roofline
from portbench.analyses import sync, to_host
from portbench.frames import system_module
from portbench.reference import aligned_rmsf as ref_mod


def _backend(cfg, device):
    if cfg["backend"] == "mesh":
        from mdanalysis_mpi_tpu_torch.parallel.executors import MeshExecutor

        return dict(backend=MeshExecutor(
            devices=[device], batch_size=cfg["batch_size"],
            transfer_dtype=cfg["transfer_dtype"]))
    return dict(backend=cfg["backend"], device=device,
                batch_size=cfg["batch_size"],
                transfer_dtype=cfg["transfer_dtype"])


def run(u, cfg, device, stop=None, **kwargs):
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF

    a = AlignedRMSF(u, select=cfg["select"], engine=cfg["engine"])
    a.run(stop=stop, **_backend(cfg, device), **kwargs)
    sync(device)
    answer = {"rmsf": to_host(a.results["rmsf"]),
              "average": to_host(a.results["average"])}
    return answer, a.results.observability


def reference(cfg, frames, precision="float64"):
    return ref_mod.compute(cfg, frames, system_module(cfg).selection(cfg))


compare = ref_mod.compare


def least_time_s(cfg, n_frames, answer, bw, flops):
    atoms = len(system_module(cfg).selection(cfg))
    one_pass = sum(roofline.aligned_moments_s(b, atoms, cfg["transfer_dtype"],
                                              bw, flops)
                   for b in roofline.blocks(n_frames, cfg["batch_size"]))
    return 2 * one_pass


#: The control: the program's own path one precision below the
#: configuration's int16 wire, int8 (run.py's ``--sizes``).
CONTROL_SIZES = {"config": {"transfer_dtype": "int8"}}
