"""Bucket hash functors of both key widths on the int32 / int64 carriers.

Port of ``hashjoin3d_tpu/ops/hashing.py`` (``murmur32``, ``murmur64``,
boncz, Fibonacci, Knuth-multiplicative and identity in their u32 and u64
flavours, ``hash_key``, ``hash_key_np``, ``bucket_of`` and the two
registries; reference ``util/hasht.hh:17-113``, ``ht_chaining.hh:139-140``).

A u32 column rides as the int32 tensor with the same bits and a u64 column
as the int64 tensor with the same bits (``ops/layout.py``).  The 32-bit
arithmetic widens to int64 on the unsigned values, masked to 32 bits, each
32x32-bit multiply split at 16 bits of the constant so no product
overflows.  The 64-bit functors multiply on int64 directly, which wraps
exactly as u64 does; their constants above 2^63 are written as their
signed int64 images, and a logical right shift masks off the copied sign
bits.  ``*_np`` are the numpy mirrors the host checks and the in-chain
predicate walk use.
"""

from __future__ import annotations

import numpy as np
import torch

from .layout import I32, I64, U32_MASK, i64_to_u32, shr, u32_to_i64

_M32_C1 = 0x85EBCA6B
_M32_C2 = 0xC2B2AE35
_M64_C1 = 0xFF51AFD7ED558CCD
_M64_C2 = 0xC4CEB9FE1A95EC63
_KNUTH32 = 2654435761
_KNUTH64 = 11400714819323198485
_FIB32 = 2654435769.0 / float(1 << 32)
_FIB64 = 11400714819323198485.0 / float(1 << 64)
_TWO32 = float(1 << 32)
_TWO63 = float(1 << 63)
_TWO64 = float(1 << 64)


def _i64(c: int) -> int:
    """The signed int64 image of a u64 constant."""
    return c - (1 << 64) if c >= 1 << 63 else c


def shr64(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of an int64 carrier by ``0 < k < 64``."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in [0, 2^32)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32_MASK


def murmur32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 32-bit finalizer over an int32 carrier (u32 bits in and
    out)."""
    x = u32_to_i64(x)
    x = x ^ (x >> 16)
    x = _mul_u32(x, _M32_C1)
    x = x ^ (x >> 13)
    x = _mul_u32(x, _M32_C2)
    x = x ^ (x >> 16)
    return i64_to_u32(x)


def murmur64(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 64-bit finalizer over an int64 carrier (u64 bits in and
    out)."""
    x = x ^ shr64(x, 33)
    x = x * _i64(_M64_C1)
    x = x ^ shr64(x, 33)
    x = x * _i64(_M64_C2)
    return x ^ shr64(x, 33)


def boncz32(x: torch.Tensor) -> torch.Tensor:
    return shr(x, 21) ^ shr(x, 13) ^ shr(x, 7) ^ x


def boncz64(x: torch.Tensor) -> torch.Tensor:
    return (shr64(x, 7) ^ shr64(x, 13) ^ shr64(x, 17) ^ shr64(x, 23)
            ^ shr64(x, 43))


def mult32(x: torch.Tensor) -> torch.Tensor:
    """Knuth's multiplicative hash ``2654435761 * x`` mod 2^32."""
    return i64_to_u32(_mul_u32(u32_to_i64(x), _KNUTH32))


def mult64(x: torch.Tensor) -> torch.Tensor:
    """Knuth's multiplicative hash ``11400714819323198485 * x`` mod 2^64."""
    return x * _i64(_KNUTH64)


def u64_to_f64(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value of an int64 carrier as float64, rounded once (as
    a u64 -> f64 conversion rounds): the exact halves, then one sum."""
    hi = shr64(x, 32).to(torch.float64)
    lo = (x & U32_MASK).to(torch.float64)
    return hi * _TWO32 + lo


def f64_to_u64(r: torch.Tensor) -> torch.Tensor:
    """An integral float64 in [0, 2^64] as the int64 carrier of its u64
    value; 2^64 saturates to 2^64 - 1, as XLA's f64 -> u64 conversion
    does."""
    high = r >= _TWO63
    out = torch.where(high, r - _TWO64, r).to(I64)
    return torch.where(r >= _TWO64, -1, out)


def fib32(x: torch.Tensor) -> torch.Tensor:
    """The reference's double-precision Fibonacci hash at full 32-bit width
    (``util/hasht.hh:31-39``)."""
    z = _FIB32 * u32_to_i64(x).to(torch.float64)
    r = torch.floor(_TWO32 * (z - torch.floor(z)))
    return i64_to_u32(r.to(I64))


def fib64(x: torch.Tensor) -> torch.Tensor:
    """The 64-bit Fibonacci hash at full width (``util/hasht.hh:40-47``)."""
    z = _FIB64 * u64_to_f64(x)
    return f64_to_u64(torch.floor(_TWO64 * (z - torch.floor(z))))


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def murmur32_np(x) -> np.ndarray:
    """Numpy mirror of :func:`murmur32` on u32 values."""
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(_M32_C1)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(_M32_C2)
        x = x ^ (x >> np.uint32(16))
    return x


def murmur64_np(x) -> np.ndarray:
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint64(33))
        x = x * np.uint64(_M64_C1)
        x = x ^ (x >> np.uint64(33))
        x = x * np.uint64(_M64_C2)
        x = x ^ (x >> np.uint64(33))
    return x


def boncz32_np(x) -> np.ndarray:
    x = np.asarray(x, np.uint32)
    return (x >> np.uint32(21)) ^ (x >> np.uint32(13)) ^ (x >> np.uint32(7)) ^ x


def boncz64_np(x) -> np.ndarray:
    x = np.asarray(x, np.uint64)
    return ((x >> np.uint64(7)) ^ (x >> np.uint64(13))
            ^ (x >> np.uint64(17)) ^ (x >> np.uint64(23))
            ^ (x >> np.uint64(43)))


def mult32_np(x) -> np.ndarray:
    with np.errstate(over="ignore"):
        return np.uint32(_KNUTH32) * np.asarray(x, np.uint32)


def mult64_np(x) -> np.ndarray:
    with np.errstate(over="ignore"):
        return np.uint64(_KNUTH64) * np.asarray(x, np.uint64)


def fib32_np(x) -> np.ndarray:
    z = _FIB32 * np.asarray(x, np.uint32).astype(np.float64)
    return np.floor(_TWO32 * (z - np.floor(z))).astype(np.uint32)


def fib64_np(x) -> np.ndarray:
    z = _FIB64 * np.asarray(x, np.uint64).astype(np.float64)
    r = np.floor(_TWO64 * (z - np.floor(z)))
    # 2^64 saturates as in f64_to_u64; the minimum keeps numpy's cast of
    # the other branch in range (the largest double below 2^64)
    return np.where(r >= _TWO64, np.uint64(2**64 - 1),
                    np.minimum(r, _TWO64 - 2048).astype(np.uint64))


def identity32_np(x) -> np.ndarray:
    return np.asarray(x, np.uint32)


def identity64_np(x) -> np.ndarray:
    return np.asarray(x, np.uint64)


#: name -> (u32 flavour, u64 flavour), each carrier in, same-width carrier
#: out (``concepts.hh:40-47``; full-width outputs, so ``bucket_of`` applies
#: uniformly)
HASH_FUNCTORS = {
    "murmur": (murmur32, murmur64),
    "boncz": (boncz32, boncz64),
    "fib": (fib32, fib64),
    "mult": (mult32, mult64),
    "identity": (identity, identity),
}

HASH_FUNCTORS_NP = {
    "murmur": (murmur32_np, murmur64_np),
    "boncz": (boncz32_np, boncz64_np),
    "fib": (fib32_np, fib64_np),
    "mult": (mult32_np, mult64_np),
    "identity": (identity32_np, identity64_np),
}


def _functor(table: dict, hashfun, wide: bool):
    try:
        return table[hashfun][1 if wide else 0]
    except KeyError:
        raise ValueError(f"unknown hash functor {hashfun!r}; registry names: "
                         f"{sorted(table)}") from None


def hash_key(x: torch.Tensor, hashfun="murmur") -> torch.Tensor:
    """Bucket hash matched to the key width: the u64 flavour for an int64
    carrier, else the u32 one.  ``hashfun`` is a :data:`HASH_FUNCTORS` name
    or a callable, carrier in and same-width carrier out."""
    if callable(hashfun):
        return hashfun(x)
    return _functor(HASH_FUNCTORS, hashfun, x.dtype == I64)(x)


def hash_key_np(x, hashfun="murmur") -> np.ndarray:
    """Numpy mirror of :func:`hash_key` on u32 / u64 values.  A callable
    runs on the CPU carrier of ``x`` and comes back with its unsigned
    dtype."""
    x = np.asarray(x)
    wide = x.dtype.itemsize == 8
    if callable(hashfun):
        ut = np.uint64 if wide else np.uint32
        it = np.int64 if wide else np.int32
        h = hashfun(torch.from_numpy(np.ascontiguousarray(x.astype(ut))
                                     .view(it)))
        return np.asarray(h.numpy()).view(ut)
    return _functor(HASH_FUNCTORS_NP, hashfun, wide)(x)


def bucket_of(h: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """``hash % num_buckets`` in the hash's own width, unsigned, as int32.

    A 64-bit hash takes its remainder from the 32-bit halves,
    ``((hi % nb) * (2^32 % nb) + lo) % nb``: for ``nb < 2^31`` every
    product stays below 2^62."""
    if h.dtype != I64:
        return (u32_to_i64(h) % num_buckets).to(I32)
    hi = shr64(h, 32)
    lo = h & U32_MASK
    r = (hi % num_buckets) * ((1 << 32) % num_buckets) + lo
    return (r % num_buckets).to(I32)
