"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` compiles with its own ``nvcc`` call for ``sm_90a`` into
``_build/libhj3<source>-<hash>.so`` at first use (never at import: the CPU
test host has no ``nvcc``); the calls run side by side, and the libraries
load through ``ctypes``.  Each C entry point takes its pointers and the CUDA
stream as ``void*`` and returns ``cudaGetLastError()``.  Kernels launch on
PyTorch's current stream, never synchronise and allocate nothing: the Python
wrappers (``ops/scan.py``, ``ops/windowed.py``, ``ops/bitonic.py``,
``ops/chainwalk.py``, ``ops/runs.py``, ``ops/probes.py``) allocate outputs
and scratch with ``torch.empty`` or ``torch.zeros``.

The launch path every wrapper shares is kept short, because a small kernel's
call costs more on the host than on the card: :func:`kernel_device` checks
the device rule in one pass over the operands, each wrapper holds its entry
point as a module-level :class:`Kernel` (bound once, at its first call),
pointers go to ctypes as ``data_ptr()`` integers and the stream handle comes
from :func:`stream`.

``LAUNCHES`` counts, per wrapper, the calls that launched its kernel; a run
resets it with :func:`reset_launch_counts` to show which kernels a path went
through.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ._native import build_library

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

#: wrapper name -> kernel launches since the last reset
LAUNCHES = {"multi_scan": 0, "windowed_lookup": 0, "windowed_lookup_db": 0,
            "bitonic_sort_packed_segmented": 0, "bitonic_sort_segmented": 0,
            "probe_roll": 0, "probe_rotate": 0, "probe_cumsum": 0,
            "probe_onehot_matmul": 0, "probe_permute": 0,
            "probe_masked_store": 0, "probe_block_copy": 0,
            "probe_row_copy": 0, "probe_digit_histogram": 0,
            "miss_chain_sum": 0, "runs": 0, "bucket_ids": 0,
            "main_chains": 0}

_lib = None

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_S = ctypes.c_char_p
#: source in ``csrc/`` -> its entry points -> (argument types, result type)
_SIGNATURES = {
    "scan.cu": {
        # in0..in3, out0..out3, op0..op3, n, reverse, workspace, its
        # capacity in tiles, stream
        "hj3t_multi_scan": ([_P] * 8 + [_I] * 4 + [_L, _I, _P, _L, _P], _I),
        "hj3t_scan_tile": ([], _I),
        "hj3t_error_string": ([_I], _S),
    },
    "windowed.cu": {
        # table, keys, out, [bad,] T, [Tv,] n, C, W, stream
        "hj3t_windowed_lookup": ([_P, _P, _P, _P, _L, _L, _L, _I, _I, _P],
                                 _I),
        "hj3t_windowed_lookup_db": ([_P, _P, _P, _L, _L, _I, _I, _P], _I),
    },
    "radix.cu": {
        # keys, payload, out_keys, out_payload, tmp_keys, tmp_payload,
        # counts, segtot, ors, plan (host int32 words), scratch sizes (host
        # int64 words), n, log_seg, rows_from_pos, stream
        "hj3t_radix_sort_segmented": ([_P] * 11 + [_L, _I, _I, _P], _I),
    },
    "runs.cu": {
        # values, their bytes, n, n_valid, its device scalar and bytes,
        # slots, mode, srow, perm, ukey, group_start, group_len,
        # first_row, count, gid, rank, workspace, its capacity in tiles,
        # stream
        "hj3t_runs": ([_P, _I, _L, _L, _P, _I, _L, _I, _P, _P]
                      + [_P] * 8 + [_L, _P], _I),
        "hj3t_runs_tile": ([], _I),
        # bucket ids, first rows, cap, num_buckets, len, pos, scratch, its
        # bytes, workspace, its capacity in tiles, stream
        "hj3t_main_chains": ([_P, _P, _L, _L, _P, _P, _P, _L, _P, _L, _P],
                             _I),
        "hj3t_main_chains_scratch": ([_L, _L], _L),
    },
    "chainwalk.cu": {
        # keys, mask, len, out, n, T, num_buckets, mode, key bytes, stream
        "hj3t_miss_chain_sum": ([_P] * 4 + [_L] * 3 + [_I, _I, _P], _I),
        # keys, live (or null), out, n, num_buckets, mode, key bytes, stream
        "hj3t_bucket_ids": ([_P] * 3 + [_L] * 2 + [_I, _I, _P], _I),
    },
    "probes.cu": {
        # arguments as in each entry point's comment there
        "hj3t_probe_roll": ([_P, _P, _L, _I, _P], _I),
        "hj3t_probe_rotate": ([_P, _P, _P, _L, _P], _I),
        "hj3t_probe_cumsum": ([_P, _P, _L, _I, _I, _P], _I),
        "hj3t_probe_onehot_matmul": ([_P, _P, _P, _L, _P], _I),
        "hj3t_probe_permute": ([_P, _P, _P, _L, _I, _P], _I),
        "hj3t_probe_masked_store": ([_P, _P, _I, _I, _I, _P], _I),
        "hj3t_probe_block_copy": ([_P, _P, _L, _I, _P], _I),
        "hj3t_probe_row_copy": ([_P, _P, _L, _L, _I, _P], _I),
        "hj3t_probe_digit_histogram": ([_P, _P, _L, _P], _I),
    },
}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or
    ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from csrc/ at first use")
    return found


def lib() -> types.SimpleNamespace:
    """Every entry point of ``_SIGNATURES``, typed; the libraries are built
    on first call, one ``nvcc`` per source, all at once."""
    global _lib
    if _lib is None:
        cmd = [nvcc(), *NVCC_FLAGS]
        with ThreadPoolExecutor(len(_SIGNATURES)) as pool:
            built = pool.map(
                lambda src: build_library(cmd, [CSRC / src],
                                          f"hj3{Path(src).stem}"),
                _SIGNATURES)
        ns = types.SimpleNamespace()
        for so, entries in zip(built, _SIGNATURES.values()):
            handle = ctypes.CDLL(str(so))
            for name, (argtypes, restype) in entries.items():
                fn = getattr(handle, name)
                fn.argtypes, fn.restype = argtypes, restype
                setattr(ns, name, fn)
        _lib = ns
    return _lib


class Kernel:
    """One C entry point of ``_SIGNATURES``.  ``kernel(key, *args)`` calls
    it with ``args`` (pointers as ``data_ptr()`` integers or None, the
    stream from :func:`stream`), raises on a non-zero CUDA error and counts
    one launch under ``LAUNCHES[key]``.  The typed ctypes function is bound
    at the first call, which builds the libraries."""

    __slots__ = ("name", "_fn")

    def __init__(self, name: str):
        self.name = name
        self._fn = None

    def __call__(self, key: str, *args) -> None:
        fn = self._fn
        if fn is None:
            fn = self._fn = getattr(lib(), self.name)
        rc = fn(*args)
        if rc != 0:
            msg = lib().hj3t_error_string(rc).decode()
            raise RuntimeError(f"{key}: CUDA error {rc} ({msg})")
        LAUNCHES[key] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def stream(index: int) -> int:
    """The handle of PyTorch's current stream on CUDA device ``index``."""
    return torch._C._cuda_getCurrentRawStream(index)


def kernel_device(name: str, *tensors: torch.Tensor, align: int = 1) -> int:
    """A kernel wrapper's device rule, in one pass over its operands: -1 if
    every operand lies on the CPU (the wrapper takes the plain version);
    else the index of the one CUDA device that holds every operand, each
    contiguous and ``align``-byte aligned.  Anything else raises."""
    t0 = tensors[0]
    if t0.is_cuda:
        index = t0.get_device()
        for t in tensors:
            if not t.is_cuda or t.get_device() != index:
                raise ValueError(f"{name}: operands on {t.device} and "
                                 f"{t0.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: operands must be contiguous")
            if t.data_ptr() % align:
                raise ValueError(f"{name}: operands must be {align}-byte "
                                 f"aligned")
        return index
    dev = t0.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
    if dev.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return -1
