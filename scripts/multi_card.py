#!/usr/bin/env python3
"""Config 2's main path across the cards of one machine: one process
driving every card (``MeshExecutor``'s single controller) and one
process per card joined by NCCL (its multi controller), each held to
the same run on one card.

Run from the root of a checkout on a machine with several GPUs::

    python3 scripts/multi_card.py [--out DIR]

Rehearse it on the CPU at a small size (gloo between the processes, the
kernels' plain versions)::

    python3 scripts/multi_card.py --cpu 4 --atoms 4000 --frames 96 \\
        --batch 16 --waters 512 --box 24.8

The system is ``chip_smoke.py``'s phase 4 (100,000 atoms from seed 0,
the 50,000 heavy atoms selected, 2,048 frames, int16, B = 512 frames a
shard, ``AlignedRMSF(engine='fused')``) unless cut by the options.  Legs:

1. one card: ``TorchExecutor`` on the first device — the reference of
   the others — then the RMSD series and ``InterRDF`` with
   ``engine='xla'`` of ``--waters`` waters × 16 frames;
2. one process over every card: ``MeshExecutor(devices=<every card>)``;
3. one process per card (``torch.distributed``, NCCL on the cards):
   each rank stages its slice of every global batch of the heavy-atom
   frames (handed over in a ``.npy`` under ``--out``), and the moments
   merge by ``all_reduce``; the RMSD series by ``all_gather``; the ring
   RDF with its blocks moving between ranks by ``send``/``recv``.

Every run is made twice in its process and the second is timed (the
first pays the kernels' build or load and the CUDA and NCCL set-up; its
wall is printed beside).  Checks: RMSF within 5e-4 Å of leg 1 (each global batch is quantized
with one int16 scale, so the shards see other scales than one card's
512-frame blocks when a global batch is wider); the RMSD series within
1e-5 Å; the ring's counts and g(r) within 1e-5 relative of ``'xla'``;
the fused kernel launched on every shard of every global batch in both
passes.  Prints each leg's wall and frames/s; the last line is one JSON
object ``{"card": ..., "n_devices": ..., "legs": {...}}``.  Exits
non-zero when a check fails or a rank fails or runs over its time.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240
RING_FRAMES = 16


def _smoke():
    """``chip_smoke.py`` of this checkout, for its system builders."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _timed(dev, fn):
    from mdanalysis_mpi_tpu_torch.ops import fused_planar as fp

    _sync(dev)
    fp.planar_sums.launches = 0
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0, fp.planar_sums.launches


def _twice(dev, fn):
    """``fn`` run twice: the first run pays the process's first-use
    costs (the kernels' build or load, CUDA and NCCL set-up, pinned
    buffers) → (the second run's result, (first s, second s), the
    second run's fused launches)."""
    _, cold, _ = _timed(dev, fn)
    out, warm, n = _timed(dev, fn)
    return out, (cold, warm), n


def _runs(u, devices, batch):
    """AlignedRMSF (fused int16) and the RMSD series on a
    ``MeshExecutor`` over ``devices``, each run twice → {name: (result,
    (first s, second s), fused launches)}."""
    from mdanalysis_mpi_tpu_torch.analysis import AlignedRMSF, RMSD
    from mdanalysis_mpi_tpu_torch.parallel.executors import MeshExecutor

    def mesh(**kw):
        return MeshExecutor(batch_size=batch, devices=devices, **kw)

    def rmsf():
        # every run starts from the same int16 scale state
        u.trajectory.__dict__.pop("_quant_max_hints", None)
        return AlignedRMSF(u, select="heavy", engine="fused").run(
            backend=mesh(transfer_dtype="int16")).results.rmsf

    dev = devices[0]
    return {"rmsf": _twice(dev, rmsf),
            "rmsd": _twice(dev, lambda: RMSD(u, select="heavy").run(
                backend=mesh()).results.rmsd)}


def _ring(ow, devices):
    from mdanalysis_mpi_tpu_torch.analysis import InterRDF
    from mdanalysis_mpi_tpu_torch.parallel.executors import MeshExecutor

    def run():
        r = InterRDF(ow, ow, engine="ring").run(backend=MeshExecutor(
            batch_size=RING_FRAMES, devices=devices))
        return r.results.count, r.results.rdf

    out, walls, _ = _twice(devices[0], run)
    return out, walls


def rank_main(args) -> int:
    """One rank of leg 3."""
    import torch

    from mdanalysis_mpi_tpu_torch.parallel.distributed import initialize

    sys.path.insert(0, HERE)
    cs = _smoke()
    if args.cpu:
        # one intra-op thread a rank: the ranks share the host's cores
        torch.set_num_threads(1)
    dev = torch.device("cpu" if args.cpu else f"cuda:{args.rank}")
    initialize(f"127.0.0.1:{args.port}", args.nranks, args.rank,
               device=dev, timeout_s=RANK_TIMEOUT_S / 2)
    u = cs.heavy_universe(np.load(os.path.join(args.out, "heavy.npy")))
    runs = _runs(u, [dev], args.batch)
    _, ow = cs.make_water(args.waters, args.box, RING_FRAMES)
    (count, rdf), ring_walls = _ring(ow, [dev])
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"),
             rmsf=runs["rmsf"][0], rmsd=runs["rmsd"][0], count=count,
             rdf=rdf)
    print(json.dumps({"rank": args.rank, "device": str(dev),
                      "rmsf_walls": runs["rmsf"][1],
                      "launches": runs["rmsf"][2],
                      "rmsd_walls": runs["rmsd"][1],
                      "ring_walls": ring_walls}))
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def _ranks(args, n):
    """Start leg 3's ``n`` ranks, wait with a bound → their reports."""
    sys.path.insert(0, HERE)
    from mdanalysis_mpi_tpu_torch.testing import handoff_port

    holder, port = handoff_port()
    holder.close()
    base = [sys.executable, os.path.abspath(__file__), "--port", str(port),
            "--nranks", str(n), "--out", args.out, "--atoms",
            str(args.atoms), "--frames", str(args.frames), "--batch",
            str(args.batch), "--waters", str(args.waters), "--box",
            str(args.box)] + (["--cpu", str(args.cpu)] if args.cpu else [])
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(base + ["--rank", str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise SystemExit(f"a rank ran over {RANK_TIMEOUT_S} s")
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise SystemExit(f"rank {r} exited {p.returncode}:\n"
                             f"{text[-3000:]}")
    return ([json.loads(t.strip().splitlines()[-1]) for t in outs],
            time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "multi_card"))
    ap.add_argument("--cpu", type=int, default=0,
                    help="rehearse on the CPU with this many processes")
    ap.add_argument("--atoms", type=int, default=100_000)
    ap.add_argument("--frames", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--waters", type=int, default=8192)
    ap.add_argument("--box", type=float, default=62.56)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--nranks", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    if args.rank is not None:
        return rank_main(args)
    import torch

    if args.cpu:
        devices = [torch.device("cpu")] * args.cpu
        card = "cpu (rehearsal)"
    else:
        if torch.cuda.device_count() < 2:
            print("needs two or more CUDA devices", file=sys.stderr)
            return 2
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().replace("\n", "; ")
    n = len(devices)
    print(f"devices: {n} x {card}")
    cs = _smoke()
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    u = cs.make_system(args.atoms, args.frames, seed=0)
    idx = u.select_atoms("heavy").indices
    heavy = np.ascontiguousarray(
        u.trajectory.read_block(0, args.frames, sel=idx)[0])
    np.save(os.path.join(args.out, "heavy.npy"), heavy)
    uh = cs.heavy_universe(heavy)
    del u
    print(f"system: {args.atoms} atoms x {args.frames} frames, "
          f"{len(idx)} heavy, built in {time.perf_counter() - t0:.1f} s")
    failures = []

    def gate(name, err, limit):
        print(f"  {name}: {err:.3g} (limit {limit:g})")
        if not err <= limit:
            failures.append(f"{name}: {err:.3g} > {limit:g}")

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))

    def launches(name, got, want):
        # the kernels' plain versions (the CPU rehearsal) count nothing
        print(f"  {name}: fused launches {got} (expected {want})")
        if got != want and not args.cpu:
            failures.append(f"{name}: {got} fused launches, not {want}")

    from mdanalysis_mpi_tpu_torch.analysis import InterRDF

    f, b = args.frames, args.batch
    one = _runs(uh, devices[:1], b)
    mesh = _runs(uh, devices, b)
    _, ow = cs.make_water(args.waters, args.box, RING_FRAMES)

    def xla_run():
        r = InterRDF(ow, ow, engine="xla").run(
            backend="torch", device=devices[0], batch_size=RING_FRAMES)
        return r.results.count, r.results.rdf

    (xc, xr), xla_walls, _ = _twice(devices[0], xla_run)
    (mc, mr), ring_walls = _ring(ow, devices)
    reports, ranks_wall = _ranks(args, n)
    got = [np.load(os.path.join(args.out, f"rank{r}.npz"))
           for r in range(n)]

    def walls(pair):
        return f"{pair[1]:.3f} s (first {pair[0]:.3f})"

    legs = {}
    for name, runs in (("one_card", one), ("one_process", mesh)):
        legs[name] = {"rmsf_walls_s": runs["rmsf"][1],
                      "fps": f / runs["rmsf"][1][1],
                      "launches": runs["rmsf"][2],
                      "rmsd_walls_s": runs["rmsd"][1]}
        print(f"{name}: AlignedRMSF fused int16 B={b} a shard "
              f"{walls(runs['rmsf'][1])}, {f / runs['rmsf'][1][1]:.1f} "
              f"frames/s; RMSD {walls(runs['rmsd'][1])}")
    launches("one card", one["rmsf"][2], 2 * -(-f // b))
    launches("one process", mesh["rmsf"][2], 2 * -(-f // (b * n)) * n)
    gate("one process vs one card, |d rmsf| A",
         float(np.abs(mesh["rmsf"][0] - one["rmsf"][0]).max()), 5e-4)
    gate("one process vs one card, |d rmsd| A",
         float(np.abs(mesh["rmsd"][0] - one["rmsd"][0]).max()), 1e-5)
    print(f"ring RDF {len(ow)} waters x {RING_FRAMES} frames: one "
          f"process over {n} devices {walls(ring_walls)}, 'xla' on one "
          f"{walls(xla_walls)}")
    gate("one process ring vs 'xla', relative counts",
         rel(mc, xc), 1e-5)
    gate("one process ring vs 'xla', relative g(r)", rel(mr, xr), 1e-5)
    slowest = max(r["rmsf_walls"][1] for r in reports)
    legs["ranks"] = {"rmsf_walls_s": [r["rmsf_walls"] for r in reports],
                     "fps": f / slowest,
                     "launches": [r["launches"] for r in reports],
                     "rmsd_walls_s": [r["rmsd_walls"] for r in reports],
                     "ring_walls_s": [r["ring_walls"] for r in reports],
                     "wall_with_start_s": ranks_wall}
    print(f"ranks: {n} processes, AlignedRMSF "
          + " / ".join(walls(r["rmsf_walls"]) for r in reports)
          + f" ({f / slowest:.1f} frames/s by the slowest), "
          f"{ranks_wall:.1f} s with process start; RMSD "
          + " / ".join(walls(r["rmsd_walls"]) for r in reports)
          + "; ring " + " / ".join(walls(r["ring_walls"])
                                   for r in reports))
    for r in reports:
        launches(f"rank {r['rank']} on {r['device']}", r["launches"],
                 2 * -(-f // (b * n)))
    same = all(np.array_equal(got[0][k], g[k]) for g in got[1:]
               for k in got[0].files)
    print(f"  every rank holds the same results: {same}")
    if not same:
        failures.append("ranks disagree")
    gate("ranks vs one card, |d rmsf| A",
         float(np.abs(got[0]["rmsf"] - one["rmsf"][0]).max()), 5e-4)
    gate("ranks vs one card, |d rmsd| A",
         float(np.abs(got[0]["rmsd"] - one["rmsd"][0]).max()), 1e-5)
    gate("ranks ring vs 'xla', relative counts", rel(got[0]["count"], xc),
         1e-5)
    gate("ranks ring vs 'xla', relative g(r)", rel(got[0]["rdf"], xr),
         1e-5)
    legs["ring"] = {"one_process_walls_s": ring_walls,
                    "xla_walls_s": xla_walls}
    shutil.rmtree(args.out, ignore_errors=True)
    for msg in failures:
        print(f"FAIL: {msg}", file=sys.stderr)
    print(json.dumps({"card": card, "n_devices": n, "frames": f,
                      "batch": b, "legs": legs, "ok": not failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
