"""One run of one cell: set-up, the measured window, the comparison
with the plain reference and the result line.

Everything that differs between cells is data, found by name from
``BENCHMARK.json``: the cell's configuration file (``configs/``), its
traffic file (``traffic/<traffic>.json``), the frame model
(``systems/``), the frame source (``sources/``), the analysis and its
reference (``analyses/``, ``reference/``) and one reader a metric
(``metrics/<metric>.py``).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PACKAGE = "mdanalysis_mpi_tpu_torch"
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "mdanalysis_mpi_tpu")
#: a run of several ranks waits this long for them (a first run builds)
RANKS_TIMEOUT_S = 1150


class RunRefused(RuntimeError):
    """The run cannot measure: no card, too few cards, the program
    missing, or a forbidden module loaded."""


# ---------------------------------------------------------------- the cell

def load_cell(name: str, sizes: dict | None = None) -> SimpleNamespace:
    """The cell ``name`` of ``BENCHMARK.json``: its entry, configuration,
    traffic and the metrics it reports (``sizes`` overrides
    configuration and traffic keys, for rehearsals at a small size)."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; cells: "
                         f"{sorted(cells)}")
    wl = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{wl['traffic']}.json")) as f:
        traffic = json.load(f)
    sizes = sizes or {}
    cfg.update(sizes.get("config", {}))
    traffic.update(sizes.get("traffic", {}))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    n_frames = traffic.get("frames") or cfg["n_frames"]
    return SimpleNamespace(name=name, cfg=cfg, traffic=traffic,
                           e2e=e2e, per_layer=per_layer, chips=wl["chips"],
                           n_frames=int(n_frames))


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is one of
    :data:`FORBIDDEN`."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def check_program() -> None:
    """The program has to be this checkout's."""
    spec = importlib.util.find_spec(PACKAGE)
    if spec is None or not os.path.abspath(spec.origin).startswith(
            ROOT + os.sep):
        raise RunRefused(f"{PACKAGE} is not in this checkout ({ROOT})")


def log(t0: float, text: str) -> None:
    """A progress line on standard error, stamped with the seconds since
    the command started."""
    print(f"[{time.time() - t0:8.2f} s] {text}", file=sys.stderr, flush=True)


def host_rss_peak() -> int:
    """This process's peak resident memory on the host, in bytes."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def card_info(device) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu (rehearsal)",
                "power_limit": None}
    limit = None
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={dev.index or 0}",
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        limit = smi.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "power_limit": limit}


# ---------------------------------------------------------------- residency

#: the program's phases that only a block staged from the host opens
STAGING_PHASES = ("stage", "gather", "repack", "chunk_read", "wire")
#: whole analyses a resident source's fill may take before it is refused
FILL_MAX_ANALYSES = 8


class NotResident(RuntimeError):
    """A resident source's blocks did not stay on the card: its cache
    evicts or its keys miss, so the run would measure staging."""


def graph_captures() -> int:
    """The CUDA graphs the program has captured in this process."""
    from mdanalysis_mpi_tpu_torch.utils import compile_cache

    return compile_cache.counters()["graph_misses"]


def staged(phases: dict) -> list[str]:
    """The staging phases one analysis's timers hold."""
    return [p for p in STAGING_PHASES if p in phases]


def fill(source, an, cfg, device, kw, t0: float) -> None:
    """A resident source's set-up, in place of the warm-up on a prefix:
    whole analyses, with the source's keyword arguments, until one
    stages nothing and captures no graph.  On a card that is the fourth:
    the first stages every block, and each pass runs a cached group
    eagerly at its first hit and captures its graph at the second."""
    for i in range(1, FILL_MAX_ANALYSES + 1):
        before = graph_captures()
        u = source.universe()
        _, observability = an.run(u, cfg, device, **kw)
        source.release(u)
        del u
        seen = staged(observability.get("phases", {}))
        captured = graph_captures() - before
        log(t0, f"fill analysis {i}: staged {seen or 'nothing'}, "
                f"{captured} graphs captured")
        if not seen and not captured:
            return
    raise NotResident(f"after {FILL_MAX_ANALYSES} analyses the cache "
                      "still stages or captures: it cannot hold the run")


def check_resident_window(phases: list[dict], graphs_before: int) -> None:
    """Refuse a resident window in which an analysis staged a block or
    the program captured a graph."""
    bad = [(i, staged(p)) for i, p in enumerate(phases) if staged(p)]
    if bad:
        raise NotResident(f"{len(bad)} of {len(phases)} window analyses "
                          f"staged (first: analysis {bad[0][0]}, phases "
                          f"{bad[0][1]}): the blocks did not stay on the "
                          "card")
    captured = graph_captures() - graphs_before
    if captured:
        raise NotResident(f"{captured} graphs captured inside the window")


# ---------------------------------------------------------------- ranks

class Ranks:
    """The process group of a cell run over several ranks."""

    def __init__(self, rank: int, size: int):
        self.rank, self.size = rank, size

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        import torch.distributed as dist

        box = [bool(flag)]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def gather(self, obj) -> list:
        import torch.distributed as dist

        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def close(self) -> None:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(args, cell, t0: float) -> dict:
    """Run the cell's ranks, one process a card, and wait for them →
    rank 0's result.  Copied from the rank spawning of
    ``scripts/multi_card.py`` (leg 3), without its ``.npy`` handover:
    each rank makes its frames from the seed."""
    port = _free_port()
    run_py = os.path.join(HERE, "run.py")
    base = [sys.executable, run_py, "--workload", args.workload,
            "--seed", str(args.seed), "--seconds", str(args.seconds),
            "--trace", str(args.trace), "--nranks", str(cell.chips),
            "--port", str(port), "--t0", repr(t0)]
    if args.sizes:
        base += ["--sizes", args.sizes]
    if args.cpu:
        base += ["--cpu"]
    fd, out_path = tempfile.mkstemp(prefix="portbench_rank0_")
    os.close(fd)
    procs = []
    try:
        with open(out_path, "w") as out0:
            for r in range(cell.chips):
                procs.append(subprocess.Popen(
                    base + ["--rank", str(r)],
                    stdout=out0 if r == 0 else sys.stderr.fileno(),
                    cwd=ROOT))
            deadline = time.monotonic() + RANKS_TIMEOUT_S
            while any(p.poll() is None for p in procs):
                if (time.monotonic() > deadline
                        or any(p.poll() not in (None, 0) for p in procs)):
                    break
                time.sleep(0.2)
        codes = [p.poll() for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"ranks exited {codes} (None: ran over "
                               f"{RANKS_TIMEOUT_S} s or was stopped)")
        with open(out_path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        return json.loads(lines[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        os.unlink(out_path)


# ---------------------------------------------------------------- one run

def measure(args, cell, t0: float, device, ranks: Ranks | None) -> dict:
    """Set-up, window, comparison → the result line's dict (rank 0) or
    None (the other ranks)."""
    import torch

    from portbench import devtrace, frames as frames_mod, roofline

    cfg, traffic = cell.cfg, cell.traffic
    lead = ranks is None or ranks.rank == 0
    card = card_info(device)
    if torch.device(device).type == "cuda":
        from mdanalysis_mpi_tpu_torch import _build

        _build.load()
        torch.cuda.set_device(device)
        log(t0, f"kernels loaded ({_build.BUILD_SECONDS:.1f} s of nvcc); "
                f"{card['kind']}, power limit {card['power_limit']}")

    model = frames_mod.system_module(cfg)
    gen = frames_mod.Frames(cfg, args.seed, cell.n_frames, device)
    host = gen.to_host()
    del gen
    log(t0, f"{host.shape[0]} frames x {host.shape[1]} atoms made and "
            "copied to the host")
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    src_mod = importlib.import_module(
        f"portbench.sources.{traffic['source']}")
    source = src_mod.Source(cfg, traffic, host, model.topology(cfg),
                            model.dimensions(cfg))
    an = importlib.import_module(f"portbench.analyses.{cfg['analysis']}")
    log(t0, f"source {traffic['source']!r} ready")
    # keyword arguments the source gives every analysis (none for most)
    kw = getattr(source, "analysis_kwargs", {})
    resident = getattr(source, "resident", False)
    try:
        if resident:
            fill(source, an, cfg, device, kw, t0)
        else:
            u = source.universe()
            an.run(u, cfg, device,
                   stop=min(cfg["warmup_frames"], cell.n_frames))
            source.release(u)
            del u
        gc.collect()
        if ranks is not None:
            ranks.agree(True)
        setup_s = time.time() - t0
        log(t0, "warmed up; window opens")

        answers, phases, walls = [], [], []
        box = {}
        graphs_before = graph_captures() if resident else 0
        with devtrace.profiled(bool(args.trace), box):
            w0 = time.perf_counter()
            go = True
            while go:
                a0 = time.perf_counter()
                u = source.universe()
                answer, observability = an.run(u, cfg, device, **kw)
                source.release(u)
                del u
                answers.append(answer)
                phases.append(observability.get("phases", {}))
                walls.append(time.perf_counter() - a0)
                elapsed = time.perf_counter() - w0
                go = elapsed < args.seconds
                if ranks is not None:
                    go = ranks.agree(go)
            window_s = time.perf_counter() - w0
        if resident:
            check_resident_window(phases, graphs_before)
    finally:
        source.close()
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    summary = box.get("summary")
    busy = summary["busy_s"] if summary else None
    if ranks is not None:
        seen = ranks.gather({"peak": peak, "busy": busy})
        peak = max(s["peak"] for s in seen)
        if summary:
            busy = sum(s["busy"] for s in seen) / len(seen)
        ranks.close()
        if not lead:
            return None
    del source
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    # the comparison, after the window and the peak
    log(t0, f"window closed: {len(answers)} analyses in {window_s:.3f} s; "
            "reference")
    ref = an.reference(cfg, frames_mod.Frames(cfg, args.seed, cell.n_frames,
                                              device))
    log(t0, "reference done")
    limits = cfg["limits"]
    failed = 0
    for a in answers:
        one = an.compare([a], ref)
        if any(not one[k] <= limits[k] for k in limits):
            failed += 1
    worst = an.compare(answers, ref)
    correct = failed == 0 and all(worst[k] <= limits[k] for k in limits)
    log(t0, f"{len(answers)} answers compared")

    bw, flops = roofline.card_rates(card["kind"])
    ctx = SimpleNamespace(
        analysis=cfg["analysis"], setup_s=setup_s, window_s=window_s,
        frames=cell.n_frames * len(answers), phases=phases, trace=summary,
        least_time_s=(lambda: sum(
            an.least_time_s(cfg, cell.n_frames, a, bw, flops)
            for a in answers)))
    wanted = cell.per_layer if args.trace else cell.e2e
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(ctx)
        if value is None:
            if not args.trace:
                raise RuntimeError(f"{m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": card["platform"], "kind": card["kind"],
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(answers),
              "failed": failed, "metrics": metrics, "device": device_info}
    if summary:
        device_info["busy_s"] = busy
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["run"] = {"power_limit": card["power_limit"], "seed": args.seed,
                     "frames_per_analysis": cell.n_frames,
                     "analysis_s": walls,
                     "host_rss_peak_bytes": host_rss_peak()}
    result["checks"] = {k: {"value": worst[k], "limit": limits[k]}
                        for k in limits}
    return result


def report(result: dict) -> None:
    """The result as the last line of standard output, the numbers
    compared as the last lines of standard error."""
    sys.stdout.flush()
    print(f"correct: {result['correct']}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(args, t0: float) -> int:
    """The command: one run of ``args.workload``."""
    cell = load_cell(args.workload,
                     json.loads(args.sizes) if args.sizes else None)
    check_program()
    import torch

    rehearse = args.cpu
    if args.rank is None:
        if not rehearse:
            if not torch.cuda.is_available():
                raise RunRefused("torch.cuda.is_available() is False")
            if torch.cuda.device_count() < cell.chips:
                raise RunRefused(f"{cell.name} needs {cell.chips} cards; "
                                 f"{torch.cuda.device_count()} present")
        if cell.chips > 1:
            from mdanalysis_mpi_tpu_torch import _build

            if not rehearse:
                _build.build()
            result = spawn_ranks(args, cell, t0)
        else:
            result = measure(args, cell, t0, "cpu" if rehearse else "cuda:0",
                             None)
    else:
        from mdanalysis_mpi_tpu_torch.parallel.distributed import initialize

        if rehearse:
            torch.set_num_threads(1)
        device = torch.device("cpu" if rehearse else f"cuda:{args.rank}")
        initialize(f"localhost:{args.port}", args.nranks, args.rank,
                   device=device, timeout_s=600)
        result = measure(args, cell, t0, device,
                         Ranks(args.rank, args.nranks))
    found = forbidden_modules()
    if found:
        raise RunRefused(f"forbidden modules loaded: {found}")
    if result is not None:
        report(result)
    return 0
