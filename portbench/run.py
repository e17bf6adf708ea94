#!/usr/bin/env python3
"""The benchmark's command: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``mdanalysis_mpi_tpu_torch``.
It makes the cell's frames on the card from the seed, builds the
``Universe`` and warms up (``setup_s``), runs whole analyses back to
back for ``--seconds`` (the last to its end), compares every answer
with the plain float64 reference, and prints one JSON line: the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics read
from a ``torch.profiler`` trace of the window.  It exits non-zero and
prints no result without enough CUDA cards, or when ``jax``,
``jaxlib``, ``flax`` or ``mdanalysis_mpi_tpu`` is loaded.

A cell of several cards runs one process a card (this script again,
with ``--rank``), joined over ``localhost``; rank 0 prints the line.
``--sizes JSON`` (``{"config": {...}, "traffic": {...}}``) overrides keys
of the cell's configuration and traffic, for the control
(``portbench/control.py``) and rehearsals; ``--cpu`` runs on the CPU,
with the kernels' plain versions, for the tests.  Neither is a
measurement of the cell.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, in place of this script's folder: the harness's
# modules are imported as ``portbench.*`` and shadow nothing
sys.path[0] = ROOT


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--sizes", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--cpu", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--nranks", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness

    try:
        return harness.main(args, T0 if args.t0 is None else args.t0)
    except harness.RunRefused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
