"""CPU tests of the benchmark (``python -m pytest bench_cuda/tests -q``);
the few that need a card skip without one."""
