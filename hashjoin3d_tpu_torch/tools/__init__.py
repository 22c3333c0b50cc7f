"""Measurement entry points of the port, run on one CUDA GPU:

  python3 -m hashjoin3d_tpu_torch.tools.roofline [--quick]
  python3 -m hashjoin3d_tpu_torch.tools.csrprof
  python3 -m hashjoin3d_tpu_torch.tools.mosaic_probe [-k FILTER]
  python3 -m hashjoin3d_tpu_torch.tools.oocbench [--logp 27]

Each raises without a card; none falls back to the CPU.
"""
