"""Chaining hash table: the dense-direct and the compacted builds.

Port of ``hashjoin3d_tpu/ops/chaining.py`` (``ChainingTable``,
``can_use_dense_direct``, ``build_chaining_host``, ``_build_chaining_dense``
with its ``full_chain_index``, ``_build_chaining_fused``,
``_build_chaining_phase2``, ``_assemble_chaining``).  Semantics of the
reference ``HtChaining1`` (``ht_chaining.hh``): a row's bucket is
``murmur32(key) % num_buckets``; each bucket's chain is [first-inserted
row, then the rest in reverse insertion order].

When the build keys are a permutation of [0, n) (exp-1's R.k) the probe
needs no directory: ``direct[key]`` packs ``row | (chain_pos + 1) <<
direct_shift``, so one lookup answers a probe and its early-exit
comparison count.  Probes without early exit (plan CsrUU) count whole
chains: ``chain_by_key[key]`` is the chain length of the key's bucket.

Any other key column takes the compacted build: the distinct-key
directory (:class:`~.layout.GroupIndex`), the bucket histogram and, for
early-exit probes, each key's first node in chain order
(``group_min_pos``, ``group_chain_first``).  Keys in a known domain
(exp-1's S.a, exp-4's FK columns) add the dense key -> group map
``key_direct``.  Without the early-exit index and with at most half as
many distinct keys as rows, the histogram comes from the directory
(cap-sized work) instead of a sort of every row's bucket.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .hashing import bucket_of, hash_key, hash_key_np
from .layout import (I32, I64, GroupIndex, canon_key_dtype,
                     compact_group_index, empty_group_index, group_capacity,
                     i64_to_u32, inverse_permute, key_direct_index,
                     run_boundaries, sort_with_rows, sorted_histogram)


@dataclass(frozen=True)
class ChainingTable:
    """Chaining table state.  Columns are int32 carriers on one device.

    A dense-direct table has an empty directory (``groups`` holds only
    ``n_keys``) and the packed ``direct`` image; a compacted one has the
    directory, ``key_direct`` where the key domain is known, and
    ``group_min_pos`` / ``group_chain_first`` (empty without the
    early-exit index, as is ``pos_by_row``)."""

    bucket_start: torch.Tensor  # i32[nb]
    bucket_len: torch.Tensor    # i32[nb]
    pos_by_row: torch.Tensor    # i32[n] 0-based chain position of each row
    keys: torch.Tensor          # u32[n] build keys
    direct: torch.Tensor | None = None  # u32[n] packed (row | pos1 << shift)
    direct_shift: int = 0
    num_buckets: int = 1
    hashfun: str = "murmur"
    #: i32[n] full chain length of each key's bucket (``full_chain_index``)
    chain_by_key: torch.Tensor | None = None
    #: distinct-key directory (empty arrays on a dense-direct table)
    groups: GroupIndex | None = None
    #: i32[cap] minimum chain position among each key's rows
    group_min_pos: torch.Tensor | None = None
    #: i32[cap] the row at that position (the early-exit probe's match)
    group_chain_first: torch.Tensor | None = None
    #: i32[domain] key -> group, -1 = absent
    key_direct: torch.Tensor | None = None

    def memory_consumption(self) -> dict:
        """Device bytes of the table, split like the reference's
        ``memoryConsupmtion{,Dir,Chains}`` (``ht_chaining.hh:161-177``):
        ``dir`` the per-bucket arrays, ``chains`` everything row- or
        group-sized."""
        dir_bytes = _nbytes(self.bucket_start, self.bucket_len)
        g = self.groups
        group_arrays = (() if g is None else
                        (g.ukey, g.group_start, g.group_len, g.group_rows,
                         g.first_row, g.gid_by_row))
        chains = _nbytes(self.pos_by_row, self.group_min_pos,
                         self.group_chain_first, self.keys, *group_arrays,
                         self.direct, self.key_direct, self.chain_by_key)
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
    empty = torch.zeros(0, dtype=I32, device=keys.device)
    return ChainingTable(bucket_start=bucket_start, bucket_len=bucket_len,
                         pos_by_row=pos_by_row, keys=keys, direct=direct,
                         direct_shift=direct_shift, num_buckets=num_buckets,
                         hashfun=hashfun, chain_by_key=chain_by_key,
                         groups=empty_group_index(n, keys.device),
                         group_min_pos=empty, group_chain_first=empty)


def build_chaining_host(keys: torch.Tensor, num_buckets: int,
                        dense_direct: bool = False,
                        n_keys: int | None = None,
                        key_domain: int | None = None,
                        early_exit_index: bool = True,
                        full_chain_index: bool = False,
                        hashfun: str = "murmur") -> ChainingTable:
    """Build a chaining table from a u32 key column (int32 carrier) on its
    own device.

    Permutation keys (``dense_direct`` with ``n_keys == len(keys)``) take
    the slim dense build; ``full_chain_index`` adds ``chain_by_key`` there
    (plan CsrUU).  Otherwise the directory is compacted to ``cap =
    group_capacity(n_keys)`` entries: with ``n_keys`` given the build runs
    without reading anything back; without it the distinct count is read
    back once after the key sort.  ``key_domain`` adds ``key_direct``;
    ``early_exit_index=False`` (tables only probed without early exit:
    Crs, exp-4's Chj) leaves out the chain-position index.
    """
    canon_key_dtype(keys)
    n = keys.shape[0]
    if dense_direct and n_keys == n:
        return _build_chaining_dense(keys, num_buckets,
                                     full_chain_index=full_chain_index,
                                     hashfun=hashfun)
    if n_keys is not None:
        return _build_chaining_fused(keys, group_capacity(n_keys, n),
                                     num_buckets, dense_direct, key_domain,
                                     early_exit_index, hashfun)
    skey, srow, nk = sort_with_rows(keys)
    cap = group_capacity(int(nk), n)  # the one host read
    return _build_chaining_phase2(keys, skey, srow, cap, num_buckets,
                                  dense_direct, key_domain, early_exit_index,
                                  hashfun)


def _build_chaining_fused(keys: torch.Tensor, cap: int, num_buckets: int,
                          dense_direct: bool, key_domain: int | None = None,
                          early_exit_index: bool = True,
                          hashfun: str = "murmur", drop_pad_key: bool = False,
                          rows=None) -> ChainingTable:
    """The compacted build with a known capacity: phase-1 sort, then
    :func:`_build_chaining_phase2`, with no count read between them.
    ``drop_pad_key`` and ``rows`` (the distributed builds) are not
    ported yet."""
    if drop_pad_key or rows is not None:
        raise NotImplementedError(
            "_build_chaining_fused: drop_pad_key / rows (the distributed "
            "builds) come with ROADMAP slice 6")
    skey, srow, _ = sort_with_rows(keys)
    return _build_chaining_phase2(keys, skey, srow, cap, num_buckets,
                                  dense_direct, key_domain, early_exit_index,
                                  hashfun)


def _build_chaining_phase2(keys: torch.Tensor, skey: torch.Tensor,
                           srow: torch.Tensor, cap: int, num_buckets: int,
                           dense_direct: bool, key_domain: int | None = None,
                           early_exit_index: bool = True,
                           hashfun: str = "murmur",
                           drop_pad_key: bool = False,
                           row_values=None) -> ChainingTable:
    """Directory, bucket histogram and chain-position index from the
    phase-1 sort.

    Without the early-exit index and with ``2 * cap <= n`` the histogram
    over rows is the per-bucket sum of the distinct keys' group sizes: one
    stable sort of the cap group buckets, their runs (K3) and an int64
    cumsum give each bucket's segment sum.  Otherwise every row's bucket
    is sorted; the early-exit index then takes each key's first node in
    chain order: the bucket's directory node (position 0) if the key owns
    it, else its last-inserted row (LIFO head insertion).
    ``drop_pad_key`` and ``row_values`` (the distributed builds) are not
    ported yet.
    """
    if drop_pad_key or row_values is not None:
        raise NotImplementedError(
            "_build_chaining_phase2: drop_pad_key / row_values (the "
            "distributed builds) come with ROADMAP slice 6")
    n = keys.shape[0]
    dev = keys.device
    groups = compact_group_index(keys, skey, srow, cap)
    empty = torch.zeros(0, dtype=I32, device=dev)

    if not early_exit_index and 2 * cap <= n:
        validg = groups.group_len > 0
        b_g = torch.where(validg, bucket_of(hash_key(groups.ukey, hashfun),
                                            num_buckets), num_buckets)
        bs, order = torch.sort(b_g, stable=True)
        ls = groups.group_len[order]
        is_f, _, r_start, r_len = run_boundaries(bs, validg.sum(dtype=I32))
        csum = torch.cumsum(ls, 0, dtype=I64)
        seg_end = csum[torch.clamp(r_start + r_len - 1, 0, cap - 1).long()]
        seg_before = torch.where(
            r_start > 0, csum[torch.clamp(r_start - 1, min=0).long()], 0)
        # each run's sum at its bucket; every other entry to a slot of its
        # own past the histogram
        slot = torch.arange(cap, dtype=I32, device=dev)
        tgt = torch.where(is_f, bs, num_buckets + slot)
        bucket_len = torch.zeros(num_buckets + cap, dtype=I32, device=dev)
        bucket_len[tgt.long()] = (seg_end - seg_before).to(I32)
        bucket_len = bucket_len[:num_buckets]
        bucket_start = torch.cumsum(bucket_len, 0, dtype=I32) - bucket_len
        return _assemble_chaining(groups, bucket_start, bucket_len, empty,
                                  empty, empty, keys, num_buckets,
                                  dense_direct, key_domain, hashfun)

    row = torch.arange(n, dtype=I32, device=dev)
    b = bucket_of(hash_key(keys, hashfun), num_buckets)
    b_sorted, srow_b = torch.sort(b, stable=True)
    is_first_b, _, run_start_b, run_len_b = run_boundaries(b_sorted, n)
    bucket_start, bucket_len = sorted_histogram(b_sorted, num_buckets,
                                                is_first_b, run_len_b)
    if not early_exit_index or n == 0:
        return _assemble_chaining(groups, bucket_start, bucket_len, empty,
                                  empty, empty, keys, num_buckets,
                                  dense_direct, key_domain, hashfun)
    rank = row - run_start_b
    pos_sorted = torch.where(rank == 0, 0, run_len_b - rank)
    pos_by_row = inverse_permute(srow_b.to(I32), pos_sorted)
    last = n - 1
    gs = torch.clamp(groups.group_start
                     + torch.clamp(groups.group_len - 1, min=0), max=last)
    max_row = srow[gs.long()]  # rows ascend within a key run
    pos_first = pos_by_row[torch.clamp(groups.first_row, max=last).long()]
    pos_max = pos_by_row[torch.clamp(max_row, max=last).long()]
    head = pos_first == 0
    live = groups.group_len > 0
    group_min_pos = torch.where(live, torch.where(head, 0, pos_max), n)
    group_chain_first = torch.where(
        live, torch.where(head, groups.first_row, max_row), -1)
    return _assemble_chaining(groups, bucket_start, bucket_len, pos_by_row,
                              group_min_pos.to(I32),
                              group_chain_first.to(I32), keys, num_buckets,
                              dense_direct, key_domain, hashfun)


def _assemble_chaining(groups, bucket_start, bucket_len, pos_by_row,
                       group_min_pos, group_chain_first, keys, num_buckets,
                       dense_direct, key_domain, hashfun="murmur"):
    n = keys.shape[0]
    direct = None
    direct_shift = 0
    if dense_direct:
        # permutation keys: cap == n, ukey[g] == g, singleton groups
        direct_shift = (n - 1).bit_length()
        direct = i64_to_u32(groups.first_row.to(I64)
                            | ((group_min_pos.to(I64) + 1) << direct_shift))
    key_direct = (key_direct_index(groups, key_domain)
                  if key_domain is not None and not dense_direct else None)
    return ChainingTable(bucket_start=bucket_start, bucket_len=bucket_len,
                         pos_by_row=pos_by_row, keys=keys, direct=direct,
                         direct_shift=direct_shift, num_buckets=num_buckets,
                         hashfun=hashfun, groups=groups,
                         group_min_pos=group_min_pos,
                         group_chain_first=group_chain_first,
                         key_direct=key_direct)
