"""Synthetic data generation: experiment-1 and experiment-4 inputs and
``GenRandIntVec``'s integer columns, bit-exact with the reference.

The generator is ``hashjoin3d_tpu_torch/native/hj3gen.cpp``, the port's own
byte-equal copy of the JAX package's ``native/hj3gen.cpp``: it calls the
same libstdc++ facilities as the reference binaries in the same order, so
streams are bit-identical to theirs.  It is compiled from that source with
``g++`` into ``hashjoin3d_tpu_torch/_build/`` at first use and loaded with
``ctypes``; nothing of the JAX package is imported or read.

:func:`gen_rand_int_vec` and :func:`mt19937_stream` (port of
``hashjoin3d_tpu/utils/gen.py``) take ``backend="native"`` (the library,
the default) or ``"python"``, the pure-Python replica of
``mt19937.py``; the two give equal streams for all eight distributions
(``util/GenRandIntVec.hh:24-34``: key, div, uni, exp, norm, zipf, self,
pois).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import numpy as np

from .._native import build_library
from . import mt19937 as pymt

DIST_NAMES = ["key", "div", "uni", "exp", "norm", "zipf", "self", "pois"]
KKEY, KDIV, KUNI, KEXP, KNORM, KZIPF, KSELF, KPOIS = range(8)
FLAG_FILL, FLAG_SHUFFLE = 1, 2

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
        lib.hj3_exp4.restype = None
        lib.hj3_exp4.argtypes = [ctypes.c_uint32] * 5 + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.hj3_gen_int_vec.restype = ctypes.c_int
        lib.hj3_gen_int_vec.argtypes = [
            ctypes.c_int, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.c_void_p]
        lib.hj3_mt19937_stream.restype = None
        lib.hj3_mt19937_stream.argtypes = [ctypes.c_int64, ctypes.c_uint64,
                                           ctypes.c_void_p]
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


def exp4_data(log2_card_r: int, alpha: int, mult_a: int, beta: int,
              mult_b: int, shuffle: bool = True):
    """``(S_a, T_a)`` as u32 numpy columns, each of ``(2^R >> alpha) *
    mult_a + (2^R >> beta) * mult_b`` rows: the common FK values [0,
    nCommon) ``mult_a`` times each, then S's exclusive values [nCommon,
    nCommon + nExcl) or T's [nCommon + nExcl, nCommon + 2 nExcl) ``mult_b``
    times each, shuffled in the reference's order
    (``main_experiment4.cc:517-575``).  R.k is the iota 0 .. 2^R - 1."""
    if not 0 <= alpha <= log2_card_r <= 31 or not 0 <= beta <= log2_card_r:
        raise ValueError("need 0 <= alpha, beta <= log2_card_r <= 31")
    if mult_a < 0 or mult_b < 0:
        raise ValueError("multiplicities must be >= 0")
    card_r = 1 << log2_card_r
    card = (card_r >> alpha) * mult_a + (card_r >> beta) * mult_b
    sa = np.empty(card, np.uint32)
    ta = np.empty(card, np.uint32)
    _gen_lib().hj3_exp4(log2_card_r, alpha, mult_a, beta, mult_b,
                        int(shuffle), sa.ctypes.data, ta.ctypes.data)
    return sa, ta


def _native(backend: str) -> bool:
    if backend not in ("native", "python"):
        raise ValueError(f"backend must be 'native' or 'python', "
                         f"got {backend!r}")
    return backend != "python"


def mt19937_stream(n: int, seed: int | None = None,
                   backend: str = "native") -> np.ndarray:
    """``n`` raw engine outputs of a ``std::mt19937`` (``seed`` None: the
    default 5489)."""
    if _native(backend):
        out = np.empty(n, np.uint32)
        _gen_lib().hj3_mt19937_stream(-1 if seed is None else seed, n,
                                      out.ctypes.data)
        return out
    return pymt.MT19937(5489 if seed is None else seed).stream(n)


def _py_gen_int_vec(dist, card, maxv, shift, param, flags, order, rng):
    """The python backend of :func:`gen_rand_int_vec`, drawing from
    ``rng`` in the reference's order (``GenRandIntVec.cc``)."""
    fill = bool(flags & FLAG_FILL)
    shuf = bool(flags & FLAG_SHUFFLE)
    v = np.empty(card, np.uint32)

    def finish(v):
        if order < 0:
            # the reference's permutation draw pattern (GenRandIntVec.cc:
            # 335-340)
            for i in range(card - 1, 0, -1):
                j = rng() % i
                v[i], v[j] = v[j], v[i]
        elif order > 0:
            v.sort()
        return v

    if dist == KKEY:
        return finish(np.arange(card, dtype=np.uint32))
    if dist == KDIV:
        return finish(np.arange(card, dtype=np.uint32) // np.uint32(param))

    def draw():
        if dist == KUNI:
            return pymt.std_uniform_int(rng, 0, maxv - 1)
        if dist == KZIPF:
            return (zipf(rng) - 1 + shift) % maxv
        if dist == KSELF:
            u = rng() / 4294967295.0
            return int(maxv * u ** (np.log(param) / np.log(1.0 - param)))
        if dist == KEXP:
            # genval_exp (GenRandIntVec.cc:272-274)
            return int(math.floor(exp_d(rng) * maxv + shift)) % maxv
        if dist == KNORM:
            # genval_norm (GenRandIntVec.cc:277-288): truncate, draw again
            # until the double lands in [0, max)
            while True:
                x = norm_d(rng)
                if 0 <= x < maxv:
                    return (int(x) + shift) % maxv
        if dist == KPOIS:
            return (pois_d(rng) + shift) % maxv
        raise ValueError(f"bad dist code {dist}")

    zipf = pymt.ZipfSampler(maxv, param) if dist == KZIPF else None
    exp_d = pymt.StdExponential(param) if dist == KEXP else None
    norm_d = pymt.StdNormal(maxv / 2.0, param) if dist == KNORM else None
    pois_d = pymt.StdPoisson(param) if dist == KPOIS else None

    if fill or shuf:
        freq = np.ones(maxv, np.uint32) if fill else np.zeros(maxv, np.uint32)
        for _ in range(card - (maxv if fill else 0)):
            freq[draw()] += 1
        if shuf and dist != KUNI:  # the reference's uni path never shuffles
            for i in range(maxv - 1, 0, -1):
                j = rng() % i
                freq[i], freq[j] = freq[j], freq[i]
        v = np.repeat(np.arange(maxv, dtype=np.uint32), freq)
    else:
        for i in range(card):
            v[i] = draw()
    return finish(v)


def gen_rand_int_vec(dist, card, maxv, shift=0, param=0.0, flags=0, order=0,
                     seed=None, backend="native") -> np.ndarray:
    """An integer column as ``GenRandIntVec::generate`` makes it.

    ``dist`` is a code or a :data:`DIST_NAMES` name; ``flags`` ORs
    ``FLAG_FILL`` / ``FLAG_SHUFFLE``; ``order`` -1 permutes, 0 keeps, +1
    sorts; ``seed=None`` is the default-seeded mt19937 (5489)."""
    if isinstance(dist, str):
        dist = DIST_NAMES.index(dist)
    if _native(backend):
        out = np.empty(card, np.uint32)
        rc = _gen_lib().hj3_gen_int_vec(dist, card, maxv, shift, param,
                                        flags, order,
                                        -1 if seed is None else seed,
                                        out.ctypes.data)
        if rc != 0:
            raise ValueError(f"bad dist code {dist}")
        return out
    rng = pymt.MT19937(5489 if seed is None else seed)
    return _py_gen_int_vec(dist, card, maxv, shift, param, flags, order, rng)
