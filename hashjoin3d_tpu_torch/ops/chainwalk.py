"""Bucket hashes in one pass: every whole-bucket chain walk (kernel MW) and
the builds' bucket ids (kernel HB), both of ``csrc/chainwalk.cu``.

A probe that walks its whole bucket chain counts that chain's length: the
misses of an early-exit probe, and every live probe of a walk without early
exit (no ``unique``).  Their comparisons are the sum of their buckets'
chain lengths, and :func:`miss_chain_sum` computes that sum straight from
the keys, for the probe strands and the probe ops alike: each masked key's
bucket, ``bucket_of(hash_key(key, hashfun), num_buckets)``, reads its
length in ``bucket_len`` (a bucket past the table reads 0) and the lengths
add up in int64.  A sum does not depend on order, so nothing is sorted.

:func:`bucket_ids` is that bucket itself, for each key of a build's column
(or directory), parked at ``num_buckets`` where ``live`` says the row or
group is dead: what every build's ``hj.build.hash`` phase computes.

On CUDA tensors both launch one kernel.  For the ``"murmur"`` and
``"identity"`` functors the kernels hash each key themselves, in the key's
width.  For every other functor, a callable included, the hash is computed
here with :func:`~.hashing.hash_key`: MW gathers and sums the bucket ids
:func:`~.hashing.bucket_of` takes from it, and HB buckets it in its identity
mode, which is ``bucket_of`` bit for bit.  Both raise for a ``num_buckets``
outside [1, 2^31) on every device.  On CPU tensors each runs its plain twin
(:func:`miss_chain_sum_plain`, :func:`bucket_ids_plain`).
"""

from __future__ import annotations

import torch

from .. import kernels
from .hashing import bucket_of, hash_key
from .layout import I32, I64

_MW = kernels.Kernel("hj3t_miss_chain_sum")
_HB = kernels.Kernel("hj3t_bucket_ids")
#: functors the kernels hash themselves -> their mode (0: MW sums the
#: caller's bucket ids)
_KERNEL_MODES = {"identity": 1, "murmur": 2}


def _check(keys, mask, bucket_len, num_buckets) -> None:
    if keys.dim() != 1 or keys.dtype not in (I32, I64):
        raise ValueError("keys must be a 1-D int32 or int64 carrier")
    if mask.dtype != torch.bool or mask.shape != keys.shape:
        raise ValueError("mask must be a bool tensor shaped like the keys")
    if bucket_len.dim() != 1 or bucket_len.dtype != I32:
        raise ValueError("bucket_len must be a 1-D int32 tensor")
    if not 1 <= num_buckets < 1 << 31:
        raise ValueError(f"num_buckets {num_buckets} must lie in [1, 2^31)")


def miss_chain_sum(keys: torch.Tensor, mask: torch.Tensor,
                   bucket_len: torch.Tensor, num_buckets: int,
                   hashfun="murmur") -> torch.Tensor:
    """The chain lengths the ``mask``-ed probes walk, summed: a 0-dim int64
    tensor on the keys' device.  ``mask`` marks the misses of an early-exit
    probe, or every live probe of a walk without early exit.

    ``keys``: the probe keys on their carrier (int32 for u32, int64 for
    u64), contiguous; ``mask``: bool, True where the probe walks;
    ``bucket_len``: int32 chain length per bucket.  ``hashfun`` is a
    :data:`~.hashing.HASH_FUNCTORS` name or a callable, as in
    :func:`~.hashing.hash_key`."""
    _check(keys, mask, bucket_len, num_buckets)
    dev = kernels.kernel_device("miss_chain_sum", keys, mask, bucket_len)
    if dev < 0:
        return miss_chain_sum_plain(keys, mask, bucket_len, num_buckets,
                                    hashfun)
    mode = _KERNEL_MODES.get(hashfun, 0) if isinstance(hashfun, str) else 0
    if mode == 0:
        keys = bucket_of(hash_key(keys, hashfun), num_buckets)
    out = torch.empty((), dtype=I64, device=keys.device)
    _MW("miss_chain_sum", keys.data_ptr(), mask.data_ptr(),
        bucket_len.data_ptr(), out.data_ptr(), keys.shape[0],
        bucket_len.shape[0], num_buckets, mode, keys.element_size(),
        kernels.stream(dev))
    return out


def miss_chain_sum_plain(keys: torch.Tensor, mask: torch.Tensor,
                         bucket_len: torch.Tensor, num_buckets: int,
                         hashfun="murmur") -> torch.Tensor:
    """Exact PyTorch version of :func:`miss_chain_sum` (any device)."""
    T = bucket_len.shape[0]
    b = bucket_of(hash_key(keys, hashfun), num_buckets).long()
    walked = bucket_len[b.clamp(max=T - 1)]
    return torch.where(mask & (b < T), walked, 0).to(I64).sum()


def bucket_ids(keys: torch.Tensor, num_buckets: int, hashfun="murmur",
               live: torch.Tensor | None = None) -> torch.Tensor:
    """Each key's bucket, ``bucket_of(hash_key(keys, hashfun),
    num_buckets)``, as int32; ``num_buckets`` where ``live`` (bool, shaped
    like the keys) is False.  ``keys``: a 1-D int32 (u32) or int64 (u64)
    carrier; ``hashfun`` a :data:`~.hashing.HASH_FUNCTORS` name or a
    callable, as in :func:`~.hashing.hash_key`; ``num_buckets`` in
    [1, 2^31), on every device."""
    if keys.dim() != 1 or keys.dtype not in (I32, I64):
        raise ValueError("keys must be a 1-D int32 or int64 carrier")
    if live is not None and (live.dtype != torch.bool
                             or live.shape != keys.shape):
        raise ValueError("live must be a bool tensor shaped like the keys")
    if not 1 <= num_buckets < 1 << 31:
        raise ValueError(f"num_buckets {num_buckets} must lie in [1, 2^31)")
    keys = keys.contiguous()
    live = None if live is None else live.contiguous()
    dev = kernels.kernel_device("bucket_ids", keys,
                                *(() if live is None else (live,)))
    if dev < 0:
        return bucket_ids_plain(keys, num_buckets, hashfun, live)
    mode = _KERNEL_MODES.get(hashfun, 0) if isinstance(hashfun, str) else 0
    if mode == 0:
        # HB's identity mode on the hash is bucket_of on it
        h = hash_key(keys, hashfun).contiguous()
        if (h.dtype not in (I32, I64) or h.shape != keys.shape
                or h.device != keys.device):
            raise ValueError("the hash functor must return a 1-D int32 or "
                             "int64 carrier shaped like the keys, on their "
                             "device")
        keys, mode = h, _KERNEL_MODES["identity"]
    out = torch.empty(keys.shape, dtype=I32, device=keys.device)
    _HB("bucket_ids", keys.data_ptr(),
        None if live is None else live.data_ptr(), out.data_ptr(),
        keys.shape[0], num_buckets, mode, keys.element_size(),
        kernels.stream(dev))
    return out


def bucket_ids_plain(keys: torch.Tensor, num_buckets: int, hashfun="murmur",
                     live: torch.Tensor | None = None) -> torch.Tensor:
    """Exact PyTorch version of :func:`bucket_ids` (any device)."""
    b = bucket_of(hash_key(keys, hashfun), num_buckets)
    return b if live is None else torch.where(live, b, num_buckets)
