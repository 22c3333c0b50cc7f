"""Sorts, the radix partition, the probe-sort policy and segmented sorts.

Port of ``hashjoin3d_tpu/ops/sort.py`` (``sort_by_key``, ``sort_rows``,
``radix_partition``, ``probe_sort_chunk``, ``window_for_chunk``,
``sort_segmented``).  The first three are the
engine's sort operator and the single-chip hash partition; they sort with
the library (the JAX package's ``lax.sort``: no Pallas kernel).  The
policy numbers are the JAX package's (segments up to 2^18, windows up to
8192, 1024-key chunks), so routes and counters line up with it.  One
deliberate difference: the policy depends on shape only.  The JAX package
offers the bitonic segment cap only on a TPU backend; here it is always
offered, so CPU runs walk the same packed, segmented and miss routes as the
GPU.
"""

from __future__ import annotations

import torch

from .bitonic import (MAX_SEGMENT_BITONIC, bitonic_sort_segmented,
                      plain_sort_segmented)
from .hashing import murmur32
from .layout import (I32, I64, i64_to_u32, run_boundaries, sorted_histogram,
                     u32_to_i64, uorder)

#: Largest segment of the general segmented sort (the JAX package's XLA
#: limit; longer segments than the bitonic cap sort with ``torch.sort``).
MAX_SEGMENT = 1 << 20


def _sort_order(keys: torch.Tensor, unsigned: bool) -> torch.Tensor:
    """The stable ascending order of ``keys``: a key carrier in unsigned
    order (``unsigned``), anything else as its dtype orders it."""
    k = uorder(keys) if unsigned and keys.dtype in (I32, I64) else keys
    return torch.sort(k, stable=True).indices


def sort_by_key(keys: torch.Tensor, *payloads: torch.Tensor,
                unsigned: bool = True):
    """Stable ascending sort of payload columns by a key column; returns
    ``(sorted_keys, *sorted_payloads)``.  A key carrier sorts as its
    unsigned values; ``unsigned=False`` sorts an int32 / int64 column as
    signed."""
    order = _sort_order(keys, unsigned)
    return (keys[order], *(p[order] for p in payloads))


def sort_rows(keys: torch.Tensor, unsigned: bool = True):
    """``(sorted_keys, row_ids)``: the stable sort's permutation handle."""
    order = _sort_order(keys, unsigned)
    return keys[order], order.to(I32)


def radix_partition(keys: torch.Tensor, num_partitions: int,
                    *payloads: torch.Tensor, by_hash: bool = True,
                    valid: torch.Tensor | None = None):
    """Partition the rows by ``murmur32(key) % p`` (``by_hash``) or by
    ``key % p``, on the keys' low 32 bits taken unsigned.

    Returns ``(part_id_sorted, keys_sorted, *payloads_sorted, part_start,
    part_len)``: one stable sort by partition (rows keep their order within
    one), the CSR over partitions from its run structure (K3).  Rows that
    are not ``valid`` park at partition ``num_partitions``, past the CSR.
    The single-chip analogue of the distributed hash-partition exchange.
    """
    k = keys if keys.dtype == I32 else i64_to_u32(keys)
    p = (u32_to_i64(murmur32(k) if by_hash else k)
         % num_partitions).to(I32)
    if valid is not None:
        p = torch.where(valid, p, num_partitions)
    psort, order = torch.sort(p, stable=True)
    is_first, _, _, run_len = run_boundaries(psort, psort.shape[0])
    part_start, part_len = sorted_histogram(psort, num_partitions, is_first,
                                            run_len)
    return (psort, k[order], *(q[order] for q in payloads), part_start,
            part_len)


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def probe_sort_chunk(P: int, domain: int | None, min_k: int = 8,
                     max_k: int = 64, align: int = 1024) -> int | None:
    """Segment size for a segmented probe sort over a key ``domain``, or
    None for a global sort.

    Each segment covers twice the pow2-ceiled domain (window-chunk spread
    well below W), at most ``max_k`` segments, boundaries on window chunks.
    The bitonic cap (2^18, one segment minimum) is tried first; its lost
    coverage margin is won back by windows up to 8192.  Then the 2^20 cap
    with at least ``min_k`` segments.
    """
    if domain is None or domain <= 0:
        return None
    chunk0 = max(2 * _pow2_ceil(domain), align)
    chunk0 = max(chunk0, _pow2_ceil(-(-P // max_k)))
    for cap, mk in ((MAX_SEGMENT_BITONIC, 1), (MAX_SEGMENT, min_k)):
        chunk = min(chunk0, cap)
        if 2 * 1024 * _pow2_ceil(domain) > 8192 * chunk:
            continue  # the needed window exceeds the 8K cap
        if chunk * mk > P or P % chunk:
            continue
        return chunk
    return None


def window_for_chunk(chunk: int | None, domain: int, C: int = 1024,
                     base_w: int = 1024, max_w: int = 8192) -> int:
    """Lookup window for streams sorted in ``chunk`` segments over
    ``domain``: twice the expected per-C-chunk key spread, capped."""
    if chunk is None:
        return base_w
    spread = -(-C * _pow2_ceil(domain) // chunk)
    W = base_w
    while W < 2 * spread and W < max_w:
        W *= 2
    return W


def sort_segmented(keys_u32: torch.Tensor, chunk: int, stable: bool = True):
    """Sort u32 keys (int32 carrier) within ``chunk`` segments; returns
    (segment-sorted keys, original row ids).  ``stable=False`` lets the
    kernel drop the row-id tiebreak (equal-key row order unspecified)."""
    P = keys_u32.shape[0]
    K = P // chunk
    dev = keys_u32.device
    lid = torch.arange(chunk, dtype=I32, device=dev).repeat(K)
    if chunk <= MAX_SEGMENT_BITONIC:
        sk, sr = bitonic_sort_segmented(keys_u32, chunk, payload=lid,
                                        stable=stable)
    else:
        sk, sr = plain_sort_segmented(keys_u32, chunk, lid)
    seg_base = torch.arange(K, dtype=I32, device=dev) * chunk
    return sk, (sr.view(K, chunk) + seg_base[:, None]).reshape(P)

