#!/usr/bin/env python3
"""Which ``torch.distributed`` gloo collectives take CUDA tensors.

The port's ``parallel/distributed.Collectives`` moves tensors through
the host for a gloo group (its ``transport_device`` is ``'cpu'`` by
default there).  This probe records why: for each collective the mesh
executor uses (``all_reduce``, ``all_gather``, ``send``/``recv`` by
``batch_isend_irecv``) two fresh processes join a gloo group on one
machine and run it on CUDA tensors of ``cuda:0``, once through the host
and once with the CUDA tensors handed to gloo directly.  Each case has
its own pair of processes and a time limit, so a case that kills or
hangs a process leaves the others standing.

Run from the root of a checkout on a machine with a GPU::

    python3 scripts/gloo_cuda_probe.py

Prints one line a case (``ok``, a wrong result, the exception, or the
exit code and last line of a process that died) and, last, one JSON
object ``{"card": ..., "torch": ..., "results": {case: outcome}}``.
Exits non-zero when a case through the host fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 90
CASES = ("all_reduce", "all_gather", "send_recv")
TRANSPORTS = ("cpu", "cuda:0")


def rank_main(rank: int, port: int, case: str, transport: str) -> str:
    """Run ``case`` through ``transport`` as ``rank`` of 2 → outcome."""
    import torch

    from mdanalysis_mpi_tpu_torch.parallel.distributed import (Collectives,
                                                               initialize)

    initialize(f"127.0.0.1:{port}", 2, rank, device="cuda:0",
               backend="gloo", timeout_s=60)
    comm = Collectives(transport_device=transport)
    x = torch.full((4,), float(rank + 1), device="cuda:0")
    call, want = {
        "all_reduce": (lambda: comm.all_reduce(x), [3.0] * 4),
        "all_gather": (lambda: comm.all_gather_cat(x),
                       [1.0] * 4 + [2.0] * 4),
        "send_recv": (lambda: comm.ring_shift(x), [float(2 - rank)] * 4),
    }[case]
    try:
        got = call()
        torch.cuda.synchronize()
    except (RuntimeError, ValueError) as exc:
        return f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
    return "ok" if got.tolist() == want else f"wrong result {got.tolist()}"


def run_case(case: str, transport: str) -> str:
    from mdanalysis_mpi_tpu_torch.testing import handoff_port

    holder, port = handoff_port()
    holder.close()
    env = dict(os.environ, PYTHONPATH=HERE)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         str(port), case, transport], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outcomes = []
    for r, p in enumerate(procs):
        try:
            text, _ = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            return f"rank {r} ran over {TIMEOUT_S} s"
        lines = [ln for ln in text.strip().splitlines()
                 if "socket.cpp" not in ln]
        last = lines[-1] if lines else ""
        if p.returncode != 0:
            outcomes.append(f"rank {r} exited {p.returncode}: {last[:200]}")
        else:
            outcomes.append(json.loads(last))
    return outcomes[0] if outcomes[0] == outcomes[1] else " | ".join(
        str(o) for o in outcomes)


def main(argv) -> int:
    if argv[:1] == ["--rank"]:
        print(json.dumps(rank_main(int(argv[1]), int(argv[2]), argv[3],
                                   argv[4])))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    results, rc = {}, 0
    for transport in TRANSPORTS:
        for case in CASES:
            key = f"{case} via {transport}"
            results[key] = run_case(case, transport)
            print(f"{key}: {results[key]}", flush=True)
            if transport == "cpu" and results[key] != "ok":
                rc = 1
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "results": results}))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
