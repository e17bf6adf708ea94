"""``InterRDF(g1, g2, nbins, range).run(...)``: staging and the pair
histogram of every frame, then g(r)."""

from __future__ import annotations

from portbench import roofline
from portbench.analyses import sync, to_host
from portbench.frames import system_module
from portbench.reference import inter_rdf as ref_mod


def run(u, cfg, device, stop=None):
    from mdanalysis_mpi_tpu_torch.analysis import InterRDF

    g1 = u.select_atoms(cfg["select_1"])
    g2 = u.select_atoms(cfg["select_2"])
    r = InterRDF(g1, g2, nbins=cfg["nbins"], range=tuple(cfg["range"]),
                 engine=cfg["engine"])
    r.run(stop=stop, backend=cfg["backend"], device=device,
          batch_size=cfg["batch_size"])
    sync(device)
    answer = {"count": to_host(r.results.count),
              "rdf": to_host(r.results.rdf)}
    return answer, r.results.observability


def reference(cfg, frames, precision="float64"):
    m = system_module(cfg)
    sel = m.selection(cfg)
    return ref_mod.compute(cfg, frames, sel, sel, m.dimensions(cfg),
                           precision)


compare = ref_mod.compare


def least_time_s(cfg, n_frames, answer, bw, flops):
    n = len(system_module(cfg).selection(cfg))
    binned = float(answer["count"].sum())
    return sum(roofline.pair_histogram_s(b, n, n, cfg["nbins"],
                                         binned * b / n_frames, bw, flops)
               for b in roofline.blocks(n_frames, cfg["batch_size"]))


def control(cfg, frames):
    """The control: the reference in the program's place, in bfloat16,
    the precision below the configuration's float32."""
    return reference(cfg, frames, precision="bfloat16")
