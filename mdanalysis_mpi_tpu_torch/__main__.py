"""CLI entry: ``python -m mdanalysis_mpi_tpu_torch <analysis> <topology>
[traj]`` (the JAX package's ``__main__``; see ``utils/config.py``).

The reference's only invocation is ``mpirun -np N python RMSF.py`` with
every knob hardcoded (RMSF.py:34,56,63,77); this exposes the same
pipeline (and the rest of the analyses) as a proper command, on the
card unless ``--device`` or ``--backend serial`` says otherwise.
``python -m mdanalysis_mpi_tpu_torch ingest TRAJ --out DIR`` writes a
block store.

Multi-tenant mode: ``python -m mdanalysis_mpi_tpu_torch batch
jobs.json`` runs a JSON job file through the serving scheduler (request
coalescing, shared-cache admission, per-job reliability; dispatched in
``utils/config.main``), on the card unless the job file's defaults say
``"device": "cpu"`` or ``"backend": "serial"``.
"""

import sys

from mdanalysis_mpi_tpu_torch.utils.config import main

sys.exit(main())
