"""hashjoin3d_tpu_torch: the PyTorch/CUDA port of hashjoin3d_tpu.

The same engine (dense CSR hash tables, sorted windowed probe strands, the
experiment harnesses with reference-exact CSV counters) written as plain
PyTorch functions on tensors, with every Pallas TPU kernel of the ported path
replaced by a hand-written CUDA kernel for Hopper (``csrc/*.cu``, built by
``kernels.py`` with ``nvcc`` and bound through ``ctypes``).

Layout mirrors ``hashjoin3d_tpu``:
  ops/      hashing, integer carriers and scans, the kernels' wrappers,
            the chaining table and the windowed probe strand
  models/   experiment harnesses (exp-1 plan Csr)
  utils/    data generation (the reference-exact native generator), CSV
            writer, repetition protocol
  convert.py  JAX-table -> port-table conversion (differential tests)

Rules that hold everywhere:
  * nothing here imports ``jax`` (only the differential tests use both);
  * u32 columns ride as int32 bit patterns (``ops/layout.py``); counters are
    int64;
  * every function takes its device from its input tensors or an explicit
    ``device`` argument.  A kernel wrapper runs its plain PyTorch version only
    for CPU tensors; for CUDA tensors it launches its kernel or raises.
"""

__version__ = "0.1.0"
