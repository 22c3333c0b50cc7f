"""Murmur3 32-bit finalizer and bucket assignment on int32 carriers.

Port of ``hashjoin3d_tpu/ops/hashing.py`` (``murmur32``, ``hash_key``,
``bucket_of``; reference ``util/hasht.hh:49-72``, ``ht_chaining.hh:139-140``).
The arithmetic runs in int64 on the unsigned values, masked to 32 bits.  Each
32x32-bit multiply is split at 16 bits of the constant so no int64 product
overflows.  ``murmur32_np`` is the host mirror the dense-direct check uses.
"""

from __future__ import annotations

import numpy as np
import torch

from .layout import I32, U32_MASK, i64_to_u32, u32_to_i64

_M32_C1 = 0x85EBCA6B
_M32_C2 = 0xC2B2AE35


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


def _not_ported(hashfun) -> NotImplementedError:
    return NotImplementedError(
        f"hash functor {hashfun!r} is not ported yet: only 'murmur' "
        "(ROADMAP slice 5 brings the other functors)")


def hash_key(x: torch.Tensor, hashfun: str = "murmur") -> torch.Tensor:
    """Bucket hash of a u32 key column (``hashjoin3d_tpu.ops.hashing.
    hash_key`` for 32-bit keys)."""
    if hashfun != "murmur":
        raise _not_ported(hashfun)
    return murmur32(x)


def hash_key_np(x, hashfun: str = "murmur") -> np.ndarray:
    if hashfun != "murmur":
        raise _not_ported(hashfun)
    return murmur32_np(x)


def bucket_of(h: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """``hash % num_buckets`` on the unsigned hash, as int32."""
    return (u32_to_i64(h) % num_buckets).to(I32)
