"""The benchmark of ``hashjoin3d_tpu_torch`` on NVIDIA H100 cards.

``python3 bench_cuda/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell needs is found by name: its configuration
under ``configs/``, its traffic mix under ``workloads/``, the data recipe
under ``recipes/``, the entry into the program under ``entries/``, the
plain reference under ``references/`` and each per-layer metric's reader
under ``metrics/``.  Nothing here imports ``jax`` or the JAX package.
"""
