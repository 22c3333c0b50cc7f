"""Nested ("3D") hash table: the dense-direct and the compacted builds.

Port of ``hashjoin3d_tpu/ops/nested.py`` (``NestedTable``,
``can_use_dense_direct``, ``build_nested_host``, ``_build_nested_dense``,
``_build_nested_fused``, ``_build_nested_phase2``).  Semantics of the
reference ``HtNested1`` (``ht_nested.hh:71-251``): one MainNode per
distinct build key, its duplicate rows in a SubNode list.  A probe walks
the bucket's main chain, one node per distinct key, so its comparison
count is the 1-based position of the matching MainNode, or the whole main
chain on a miss.  New distinct keys APPEND at the chain tail
(``ht_nested.hh:286-311``), so main-chain order is first-occurrence
order; the chaining table head-inserts instead.

The dense equivalent: the MainNode directory is the compacted
:class:`~.layout.GroupIndex` (sorted distinct keys, CSR row groups), each
group's main-chain position ``main_pos_by_group`` and each bucket's
main-chain length ``bucket_main_len``.  Permutation keys (exp-1's R.k) make
every row its own MainNode: the dense-direct table keeps only the packed
``direct`` image and ``bucket_main_len``.  Keys in a known domain (exp-1's
S.a over [0, fkMax)) add the dense key -> group map ``key_direct``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .chaining import _nbytes
from .chaining import can_use_dense_direct as _chaining_dense_ok
from .hashing import bucket_of, hash_key
from .layout import (I32, I64, GroupIndex, canon_key_dtype,
                     compact_group_index, empty_group_index, group_capacity,
                     i64_to_u32, inverse_permute, key_direct_index,
                     run_boundaries, sort_with_rows, sorted_histogram)


@dataclass(frozen=True)
class NestedTable:
    """3D hash-table state.  Columns are int32 carriers on one device.

    ``main_pos_by_group[g]``: 0-based position of distinct key ``g`` in its
    bucket's main chain; ``bucket_main_len[b]``: MainNodes hashed to bucket
    ``b``.  A dense-direct table has an empty directory and packs
    ``row | (main_pos + 1) << direct_shift`` in ``direct[key]``.
    """

    groups: GroupIndex
    main_pos_by_group: torch.Tensor  # i32[cap]
    bucket_main_len: torch.Tensor    # i32[nb]
    keys: torch.Tensor               # u32[n] build key column
    num_buckets: int
    direct: torch.Tensor | None = None      # u32[n] (dense-direct)
    direct_shift: int = 0
    key_direct: torch.Tensor | None = None  # i32[domain], -1 = absent
    hashfun: str = "murmur"

    def memory_consumption(self) -> dict:
        """Device bytes of the table, split like the reference's
        ``memoryConsupmtion{,Dir,MainChains,SubChains}``
        (``ht_nested.hh:261-284``): ``dir`` the per-bucket arrays, ``main``
        the per-distinct-key arrays and indexes, ``sub`` the per-row
        arrays."""
        g = self.groups
        dir_bytes = _nbytes(self.bucket_main_len)
        main = _nbytes(self.main_pos_by_group, g.ukey, g.group_start,
                       g.group_len, g.first_row, self.direct, self.key_direct)
        sub = _nbytes(g.group_rows, g.gid_by_row, self.keys)
        return dict(total=dir_bytes + main + sub, dir=dir_bytes, main=main,
                    sub=sub)


def can_use_dense_direct(keys_np, num_buckets: int,
                         hashfun: str = "murmur") -> bool:
    """Host check that the dense-direct nested layout is exact for these
    keys (the chaining table's condition)."""
    return _chaining_dense_ok(keys_np, num_buckets, hashfun)


def build_nested_host(keys: torch.Tensor, num_buckets: int,
                      dense_direct: bool = False, n_keys: int | None = None,
                      key_domain: int | None = None,
                      hashfun: str = "murmur") -> NestedTable:
    """Build the 3D table from a u32 key column (int32 carrier) on its own
    device.

    Permutation keys (``dense_direct`` with ``n_keys == len(keys)``) take
    the slim dense build.  Otherwise the directory is compacted to
    ``cap = group_capacity(n_keys)`` entries: with ``n_keys`` given (the
    harness knows each column's distinct count) sort and directory run
    without reading the count back; without it the count is read back
    once after the sort.  A smaller ``n_keys`` than the true count
    truncates the directory.  ``key_domain`` adds the dense key -> group map.
    """
    canon_key_dtype(keys)
    if dense_direct and n_keys == keys.shape[0]:
        return _build_nested_dense(keys, num_buckets, hashfun)
    if n_keys is not None:
        cap = group_capacity(n_keys, keys.shape[0])
        return _build_nested_fused(keys, cap, num_buckets, dense_direct,
                                   key_domain, hashfun)
    skey, srow, nk = sort_with_rows(keys)
    cap = group_capacity(int(nk), keys.shape[0])  # the one host read
    return _build_nested_phase2(keys, skey, srow, cap, num_buckets,
                                dense_direct, key_domain, hashfun)


def _build_nested_dense(keys: torch.Tensor, num_buckets: int,
                        hashfun: str = "murmur") -> NestedTable:
    """Dense-direct 3D build: every row is its own MainNode, and its
    main-chain position is its ARRIVAL rank in its bucket (tail append)."""
    n = keys.shape[0]
    row = torch.arange(n, dtype=I32, device=keys.device)
    b = bucket_of(hash_key(keys, hashfun), num_buckets)
    b_sorted, srow = torch.sort(b, stable=True)
    is_first_b, _, run_start_b, run_len_b = run_boundaries(b_sorted, n)
    _, bucket_main_len = sorted_histogram(b_sorted, num_buckets, is_first_b,
                                          run_len_b)
    pos_by_row = inverse_permute(srow.to(I32), row - run_start_b)
    direct_shift = (n - 1).bit_length()
    packed = row.to(I64) | ((pos_by_row.to(I64) + 1) << direct_shift)
    direct = inverse_permute(keys, i64_to_u32(packed))
    empty = torch.zeros(0, dtype=I32, device=keys.device)
    return NestedTable(groups=empty_group_index(n, keys.device),
                       main_pos_by_group=empty,
                       bucket_main_len=bucket_main_len, keys=keys,
                       num_buckets=num_buckets, direct=direct,
                       direct_shift=direct_shift, hashfun=hashfun)


def _build_nested_fused(keys: torch.Tensor, cap: int, num_buckets: int,
                        dense_direct: bool, key_domain: int | None = None,
                        hashfun: str = "murmur") -> NestedTable:
    """The compacted build with a known capacity: phase-1 sort, then
    :func:`_build_nested_phase2`, with no count read between them."""
    skey, srow, _ = sort_with_rows(keys)
    return _build_nested_phase2(keys, skey, srow, cap, num_buckets,
                                dense_direct, key_domain, hashfun)


def _build_nested_phase2(keys: torch.Tensor, skey: torch.Tensor,
                         srow: torch.Tensor, cap: int, num_buckets: int,
                         dense_direct: bool, key_domain: int | None = None,
                         hashfun: str = "murmur") -> NestedTable:
    """Directory, main chains and indexes from the phase-1 sort.

    Groups sort by (bucket, first row): one stable sort of the two keys
    packed in an int64 word, padding groups parked at bucket
    ``num_buckets``.  Within a bucket the groups then stand in
    first-occurrence order, so a group's main-chain position is its rank
    in its bucket's run.
    """
    n = keys.shape[0]
    dev = keys.device
    groups = compact_group_index(keys, skey, srow, cap)
    validg = groups.group_len > 0
    b_main = torch.where(validg,
                         bucket_of(hash_key(groups.ukey, hashfun),
                                   num_buckets), num_buckets)
    # first_row < 2^31 and b_main <= num_buckets < 2^31: both fit a word
    packed = (b_main.to(I64) << 32) | groups.first_row.to(I64)
    pk_s, gid_s = torch.sort(packed, stable=True)
    bm_s = (pk_s >> 32).to(I32)
    n_valid_groups = validg.sum(dtype=I32)
    is_first_m, _, run_start, run_len_m = run_boundaries(bm_s,
                                                         n_valid_groups)
    _, bucket_main_len = sorted_histogram(bm_s, num_buckets, is_first_m,
                                          run_len_m)
    pos_s = torch.arange(cap, dtype=I32, device=dev) - run_start
    main_pos_by_group = inverse_permute(gid_s.to(I32), pos_s)

    direct = None
    direct_shift = 0
    if dense_direct:
        # permutation keys: cap == n, ukey[g] == g, singleton groups
        direct_shift = (n - 1).bit_length()
        direct = i64_to_u32(groups.first_row.to(I64)
                            | ((main_pos_by_group.to(I64) + 1)
                               << direct_shift))
    key_direct = (key_direct_index(groups, key_domain)
                  if key_domain is not None and not dense_direct else None)
    return NestedTable(groups=groups, main_pos_by_group=main_pos_by_group,
                       bucket_main_len=bucket_main_len, keys=keys,
                       num_buckets=num_buckets, direct=direct,
                       direct_shift=direct_shift, key_direct=key_direct,
                       hashfun=hashfun)
