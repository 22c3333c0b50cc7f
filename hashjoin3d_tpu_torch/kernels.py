"""Build and bind the hand-written CUDA kernels of ``csrc/``.

All ``csrc/*.cu`` compile in one ``nvcc`` call for ``sm_90a`` into
``_build/libhj3kernels-<hash>.so`` at first use (never at import: the CPU test
host has no ``nvcc``), and load through ``ctypes``.  Each C entry point takes
its pointers and the CUDA stream as ``void*`` and returns
``cudaGetLastError()``; :func:`count_launch` raises on a non-zero code.  Kernels
launch on PyTorch's current stream, never synchronise and allocate nothing:
the Python wrappers (``ops/scan.py``, ``ops/windowed.py``, ``ops/bitonic.py``)
allocate outputs and scratch with ``torch.empty``.

``LAUNCHES`` counts, per wrapper, the calls that launched its kernel; a run
resets it with :func:`reset_launch_counts` to show which kernels a path went
through.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

import torch

from ._native import build_library

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

#: wrapper name -> kernel launches since the last reset
LAUNCHES = {"multi_scan": 0, "windowed_lookup": 0,
            "bitonic_sort_packed_segmented": 0, "bitonic_sort_segmented": 0}

_lib = None

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # in0..in3, out0..out3, op0..op3, n, reverse, scratch, stream
    "hj3t_multi_scan": [_P] * 8 + [_I] * 4 + [_L, _I, _P, _P],
    # table, keys, out, T, n, C, W, stream
    "hj3t_windowed_lookup": [_P, _P, _P, _L, _L, _I, _I, _P],
    # keys, payload, out_keys, out_payload, n, log_seg, unsigned, stable, stream
    "hj3t_bitonic_sort_segmented": [_P, _P, _P, _P, _L, _I, _I, _I, _P],
    # keys, out_keys, out_rows, n, log_seg, key_bits, stream
    "hj3t_bitonic_sort_packed_segmented": [_P, _P, _P, _L, _I, _I, _P],
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


def lib() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    if _lib is None:
        so = build_library([nvcc(), *NVCC_FLAGS], sorted(CSRC.glob("*.cu")),
                           "hj3kernels")
        handle = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.hj3t_error_string.argtypes = [ctypes.c_int]
        handle.hj3t_error_string.restype = ctypes.c_char_p
        handle.hj3t_scan_tile.argtypes = []
        handle.hj3t_scan_tile.restype = ctypes.c_int
        _lib = handle
    return _lib


def count_launch(rc: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error, else count one
    launch for the wrapper ``name``."""
    if rc != 0:
        msg = lib().hj3t_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper's device rule: every operand a contiguous tensor on
    one CUDA device (CPU operands were routed to the plain version before)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
