"""Measurement and checking entry points of the port, run on one CUDA GPU:

  python3 -m hashjoin3d_tpu_torch.tools.roofline [--quick]
  python3 -m hashjoin3d_tpu_torch.tools.csrprof
  python3 -m hashjoin3d_tpu_torch.tools.mosaic_probe [-k FILTER]
  python3 -m hashjoin3d_tpu_torch.tools.oocbench [--logp 27]
  python3 -m hashjoin3d_tpu_torch.tools.dist_overhead [--n 22]

and the randomized differential fuzzers (``fuzzing.py`` their harness,
``oracle.py`` the reference-semantics oracle they check against):

  python3 -m hashjoin3d_tpu_torch.tools.fuzz_api [--trials N] [--seed S]
      [--tier small|large|both] [--device cuda|cpu]
  python3 -m hashjoin3d_tpu_torch.tools.fuzz_stream  (the same options)
  python3 -m hashjoin3d_tpu_torch.tools.fuzz_order   (the same options)
  python3 -m hashjoin3d_tpu_torch.tools.fuzz_dist    (the same; 4 gloo ranks)
  python3 -m hashjoin3d_tpu_torch.tools.zipf_capacity [--logp 24] [--logr 20]
      [--shards 8] [--no-run] [--device cuda|cpu]

Each raises without a card; none falls back to the CPU.  The fuzzers and
the zipf check run on the plain versions with ``--device cpu``.
"""
