"""Probe-sort policy and segmented sorts.

Port of ``hashjoin3d_tpu/ops/sort.py`` (``probe_sort_chunk``,
``window_for_chunk``, ``sort_segmented``, ``sort_segmented_1op``).  The
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
from .layout import I32

#: Largest segment of the general segmented sort (the JAX package's XLA
#: limit; longer segments than the bitonic cap sort with ``torch.sort``).
MAX_SEGMENT = 1 << 20


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


def sort_segmented_1op(vals_i32: torch.Tensor, chunk: int) -> torch.Tensor:
    """Ascending int32 sort within ``chunk`` segments (bucket-id streams
    with -1 dead markers sorting to each segment's front)."""
    if chunk <= MAX_SEGMENT_BITONIC:
        return bitonic_sort_segmented(vals_i32, chunk, unsigned=False)[0]
    return plain_sort_segmented(vals_i32, chunk, unsigned=False)[0]
