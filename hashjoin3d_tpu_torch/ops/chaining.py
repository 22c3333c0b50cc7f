"""Chaining hash table: the dense-direct build of exp-1's R side.

Port of ``hashjoin3d_tpu/ops/chaining.py`` (``ChainingTable``,
``can_use_dense_direct``, ``_build_chaining_dense`` with its
``full_chain_index``, the dense branch of ``build_chaining_host``).
Semantics of the reference ``HtChaining1`` (``ht_chaining.hh``): a row's
bucket is ``murmur32(key) % num_buckets``; each
bucket's chain is [first-inserted row, then the rest in reverse insertion
order].  When the build keys are a permutation of [0, n) (exp-1's R.k) the
probe needs no directory: ``direct[key]`` packs
``row | (chain_pos + 1) << direct_shift``, so one lookup answers a probe
and its early-exit comparison count.  Probes without early exit (plan
CsrUU) count whole chains: ``chain_by_key[key]`` is the chain length of
the key's bucket.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .hashing import bucket_of, hash_key, hash_key_np
from .layout import (I32, I64, i64_to_u32, inverse_permute, run_boundaries,
                     sorted_histogram)


@dataclass(frozen=True)
class ChainingTable:
    """Dense-direct chaining table state (the fields the Csr probe and the
    statistics read).  Columns are int32 carriers on one device."""

    bucket_start: torch.Tensor  # i32[nb]
    bucket_len: torch.Tensor    # i32[nb]
    pos_by_row: torch.Tensor    # i32[n] 0-based chain position of each row
    keys: torch.Tensor          # u32[n] build keys
    direct: torch.Tensor        # u32[n] packed (row | pos1 << direct_shift)
    direct_shift: int
    num_buckets: int
    hashfun: str = "murmur"
    #: i32[n] full chain length of each key's bucket (``full_chain_index``)
    chain_by_key: torch.Tensor | None = None

    def memory_consumption(self) -> dict:
        """Device bytes of the table, split like the reference's
        ``memoryConsupmtion{,Dir,Chains}`` (``ht_chaining.hh:161-177``):
        ``dir`` the per-bucket arrays, ``chains`` everything row-sized."""
        dir_bytes = _nbytes(self.bucket_start, self.bucket_len)
        chains = _nbytes(self.pos_by_row, self.keys, self.direct,
                         self.chain_by_key)
        return dict(total=dir_bytes + chains, dir=dir_bytes, chains=chains)


def _nbytes(*arrays) -> int:
    return sum(a.numel() * a.element_size() for a in arrays if a is not None)


def can_use_dense_direct(keys_np, num_buckets: int,
                         hashfun: str = "murmur") -> bool:
    """Host check that the dense-direct layout is exact for these keys: a
    permutation of [0, n), n a power of two, and the deepest chain position
    + 1 fits the bits above the row field."""
    keys_np = np.asarray(keys_np)
    n = keys_np.size
    if keys_np.dtype.itemsize == 8:
        return False
    if n == 0 or (n & (n - 1)) != 0:
        return False
    if keys_np.max() != n - 1 or np.bincount(keys_np, minlength=n).max() != 1:
        return False
    shift = n.bit_length() - 1
    occ = np.bincount(hash_key_np(keys_np.astype(np.uint32), hashfun)
                      % np.uint32(num_buckets))
    return int(occ.max()) < (1 << (32 - shift))


def _build_chaining_dense(keys: torch.Tensor, num_buckets: int,
                          full_chain_index: bool = False,
                          hashfun: str = "murmur") -> ChainingTable:
    """Dense-direct build (permutation keys only, see
    :func:`can_use_dense_direct`): stable sort by bucket, run structure by
    scans (K3), histogram, chain positions, and the packed ``direct``
    image; ``full_chain_index`` adds ``chain_by_key`` (key == row for
    permutation keys)."""
    n = keys.shape[0]
    row = torch.arange(n, dtype=I32, device=keys.device)
    b = bucket_of(hash_key(keys, hashfun), num_buckets)
    b_sorted, srow = torch.sort(b, stable=True)
    srow = srow.to(I32)
    is_first_b, _, run_start_b, run_len_b = run_boundaries(b_sorted, n)
    bucket_start, bucket_len = sorted_histogram(
        b_sorted, num_buckets, is_first_b, run_len_b)
    rank = row - run_start_b
    # insertion rank 0 -> chain pos 0 (directory node); rank p > 0 -> len - p
    pos_sorted = torch.where(rank == 0, 0, run_len_b - rank)
    pos_by_row = inverse_permute(srow, pos_sorted)

    direct_shift = (n - 1).bit_length()
    packed = row.to(I64) | ((pos_by_row.to(I64) + 1) << direct_shift)
    direct = inverse_permute(keys, i64_to_u32(packed))
    chain_by_key = None
    if full_chain_index:
        chain_by_key = bucket_len[
            bucket_of(hash_key(row, hashfun), num_buckets).long()]
    return ChainingTable(bucket_start=bucket_start, bucket_len=bucket_len,
                         pos_by_row=pos_by_row, keys=keys, direct=direct,
                         direct_shift=direct_shift, num_buckets=num_buckets,
                         hashfun=hashfun, chain_by_key=chain_by_key)


def build_chaining_host(keys: torch.Tensor, num_buckets: int,
                        dense_direct: bool = False,
                        n_keys: int | None = None,
                        full_chain_index: bool = False,
                        hashfun: str = "murmur") -> ChainingTable:
    """Build a chaining table from a u32 key column (int32 carrier) on its
    own device.  Only the dense-direct branch (permutation keys,
    ``dense_direct=True, n_keys=len(keys)``) is ported;
    ``full_chain_index`` materialises ``chain_by_key`` for probes that
    count whole chains (plan CsrUU)."""
    if not (dense_direct and n_keys == keys.shape[0]):
        raise NotImplementedError(
            "only the dense-direct build is ported; the compacted builds "
            "(_build_chaining_fused / _build_chaining_phase2) come with "
            "ROADMAP slice 3")
    return _build_chaining_dense(keys, num_buckets,
                                 full_chain_index=full_chain_index,
                                 hashfun=hashfun)
