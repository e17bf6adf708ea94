"""The benchmark of ``mdanalysis_mpi_tpu_torch`` on NVIDIA GPUs.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout; see ``README.md``.
"""
