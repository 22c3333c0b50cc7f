"""hashjoin3d_tpu_torch: the PyTorch/CUDA port of hashjoin3d_tpu.

The same engine (dense CSR hash tables, sorted windowed probe strands, the
experiment harnesses with reference-exact CSV counters, the one-call join)
written as plain PyTorch functions on tensors, with every Pallas TPU kernel
of the ported path replaced by a hand-written CUDA kernel for Hopper
(``csrc/*.cu``, built by ``kernels.py`` with ``nvcc`` and bound through
``ctypes``).

Layout mirrors ``hashjoin3d_tpu``:
  api.py    ``join``, the one-call API: host key columns of any width in,
            row-id pairs and the reference's counters out
  ops/      hash functors of both key widths, integer carriers, scans and
            the kernels' wrappers; the chaining and the nested ("3D")
            tables (the clarity builds over ``key_group_index``,
            dense-direct and compacted builds, ``probe_chaining``,
            ``probe_nested``, ``materialize_chaining_join``, ``unnest``,
            ``deferred_two_join_strand``); the windowed probe strands
            (dense-direct, key_direct nested and chaining, merged nested
            and chaining, exp-4's Ndu, Chj and Nnu); the in-chain
            predicate walk; filter, hash aggregate, sorts and the radix
            partition
  models/   the algebra (``Relation``, the operators, ``compile_strand``)
            and its example; experiment harnesses: ``Experiment1``
            (exp-1's eleven plans, the clarity strands where R.k is not
            dense) and ``Experiment4`` (exp-4's Ndu, Chj and Nnu, and
            their clarity strands)
  tools/    roofline, csrprof and mosaic_probe (measurement, CUDA only)
  utils/    data generation (the reference-exact native generator), CSV
            writer, repetition protocol
  convert.py  JAX-table -> port-table conversion (differential tests)

Rules that hold everywhere:
  * nothing here imports ``jax`` (only the differential tests use both);
  * u32 columns ride as int32 bit patterns and u64 columns as int64 ones
    (``ops/layout.py``); counters are int64;
  * every function takes its device from its input tensors or an explicit
    ``device`` argument.  A kernel wrapper runs its plain PyTorch version only
    for CPU tensors; for CUDA tensors it launches its kernel or raises.
"""

from .api import JoinResult, join
from .ops.layout import pack2u32

__version__ = "0.1.0"
__all__ = ["join", "JoinResult", "pack2u32"]
