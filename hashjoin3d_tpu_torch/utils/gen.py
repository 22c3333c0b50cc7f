"""Experiment-1 inputs from the reference-exact native generator.

The generator is ``hashjoin3d_tpu_torch/native/hj3gen.cpp``, the port's own
byte-equal copy of the JAX package's ``native/hj3gen.cpp``: it calls the
same libstdc++ facilities as the reference binaries in the same order, so
streams are bit-identical to theirs.  It is compiled from that source with
``g++`` into ``hashjoin3d_tpu_torch/_build/`` at first use and loaded with
``ctypes``; nothing of the JAX package is imported or read.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from .._native import build_library

GEN_SOURCE = Path(__file__).resolve().parents[1] / "native" / "hj3gen.cpp"

_lib = None


def _gen_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        so = build_library(["g++", "-O2", "-std=c++20", "-shared", "-fPIC"],
                           [GEN_SOURCE], "hj3gen")
        lib = ctypes.CDLL(str(so))
        lib.hj3_exp1.restype = ctypes.c_int64
        lib.hj3_exp1.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                 ctypes.c_int, ctypes.c_uint32,
                                 ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
    return _lib


def exp1_data(log2_card_r: int, log2_card_s: int, skew: bool, t: int):
    """``(R_k, S_a, num_dv_sa)`` as u32 numpy columns: R.k a shuffled iota
    of 2^R keys, S.a uniform (or zipf) over [0, 2^(R-t))
    (``main_experiment1.cc:415-457``)."""
    if not 0 <= t <= log2_card_r <= 31 or not 0 <= log2_card_s <= 31:
        raise ValueError("need 0 <= t <= log2_card_r <= 31, "
                         "0 <= log2_card_s <= 31")
    rk = np.empty(1 << log2_card_r, np.uint32)
    sa = np.empty(1 << log2_card_s, np.uint32)
    ndv = _gen_lib().hj3_exp1(log2_card_r, log2_card_s, int(skew), t,
                              rk.ctypes.data, sa.ctypes.data)
    return rk, sa, int(ndv)
