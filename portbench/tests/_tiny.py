"""Tiny sizes of each cell for the CPU, at which the configurations'
limits still hold for sound runs (more frames and fewer atoms than the
cells: the int16 wire's error falls as one over the root of the
frames)."""

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

RMSF = {"config": {"n_atoms": 1024, "n_frames": 2048, "batch_size": 256,
                   "warmup_frames": 256}}
STORE = {"config": {"n_atoms": 1024, "batch_size": 256,
                    "warmup_frames": 256},
         "traffic": {"frames": 2048, "chunk_frames": 256}}
RDF = {"config": {"n_waters": 512, "n_atoms": 1536, "box_A": 24.8,
                  "range": [0.0, 8.0], "n_frames": 24, "batch_size": 8,
                  "warmup_frames": 8, "engine": "pallas"}}
TINY = {"rmsf_heavy_100k.memory": RMSF, "rmsf_heavy_100k.store": STORE,
        "rdf_oo_32k.memory": RDF, "rmsf_heavy_100k_4rank.memory": RMSF}
#: the ``resident`` source, which no cell names yet: the memory cell at
#: its tiny size, its traffic swapped for ``traffic/resident.json``'s
RESIDENT = ("rmsf_heavy_100k.memory",
            dict(RMSF, traffic={"source": "resident",
                                "cache_bytes": 8589934592}))


def listed(cell):
    """The per-layer metrics ``BENCHMARK.json`` lists for ``cell``."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return {m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", ())}


def plant(tmp_path, code):
    """The environment of a run whose processes first run ``code`` (a
    ``sitecustomize`` module in ``tmp_path``)."""
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent(code))
    return {"PYTHONPATH": os.pathsep.join([str(tmp_path), ROOT])}


def with_config(sizes, **keys):
    out = json.loads(json.dumps(sizes))
    out.setdefault("config", {}).update(keys)
    return out


def run_cpu(cell, sizes, seed=12345, seconds=0.5, trace=0, env=None):
    """``run.py`` on the CPU at ``sizes`` → (exit code, result or None,
    standard error)."""
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace), "--cpu", "--sizes", json.dumps(sizes)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=None if env is None else dict(os.environ, **env))
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    return p.returncode, (json.loads(lines[-1]) if lines else None), p.stderr
