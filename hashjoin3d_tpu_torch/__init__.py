"""hashjoin3d_tpu_torch: the PyTorch/CUDA port of hashjoin3d_tpu.

The same engine (dense CSR hash tables, sorted windowed probe strands, the
experiment harnesses with reference-exact CSV counters, the one-call join)
written as plain PyTorch functions on tensors, with every Pallas TPU kernel
of the ported path replaced by a hand-written CUDA kernel for Hopper
(``csrc/*.cu``, built by ``kernels.py`` with ``nvcc`` and bound through
``ctypes``).

Layout mirrors ``hashjoin3d_tpu``:
  api.py    ``join``, the one-call API: host key columns of any width in,
            row-id pairs and the reference's counters out; ``backend``
            "device" (default), "host" or "auto"
  hostengine.py
            the native C++ host engine (``native/hj3engine.cpp``, the
            port's own copy, built with ``g++``): ``host_chaining_join``,
            ``host_nested_join``, ``HostTable``, ``host_two_join_probe``
  ops/      hash functors of both key widths (and the parametric, Fibonacci
            and CRC ones), integer carriers, scans and
            the kernels' wrappers; the chaining and the nested ("3D")
            tables (the clarity builds over ``key_group_index``,
            dense-direct and compacted builds, ``probe_chaining``,
            ``probe_nested``, ``materialize_chaining_join``, ``unnest``,
            ``deferred_two_join_strand``); the windowed probe strands
            (dense-direct, key_direct nested and chaining, merged nested
            and chaining, exp-4's Ndu, Chj and Nnu); out-of-core streaming
            (``ops/streaming.py``: a host column probed in chunks through
            pinned buffers and a side stream); the in-chain predicate
            walk; filter, hash aggregate, sorts and the radix partition
  models/   the algebra (``Relation``, the operators, ``compile_strand``)
            and its example; experiment harnesses: ``Experiment1``
            (exp-1's eleven plans, the clarity strands where R.k is not
            dense) and ``Experiment4`` (exp-4's Ndu, Chj and Nnu, and
            their clarity strands)
  tools/    roofline, csrprof, mosaic_probe and oocbench (measurement,
            CUDA only)
  utils/    data generation (the reference-exact native generator, its
            pure-Python twin ``mt19937.py`` and ``gen_rand_int_vec``), CSV
            writer, repetition protocol, ``checkpoint`` (``save_table`` /
            ``load_table``), ``tracing`` (``trace``, ``checked``, the
            phase spans ``span`` with ``records`` / ``clear``, and
            ``host_read``, counted by site in the open span) and ``misc``
  native/   the C++ sources the port builds: ``hj3gen.cpp`` (the
            generator) and ``hj3engine.cpp`` (the host engine)
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
