"""Chaining hash table: the dense-direct and the compacted builds.

Port of ``hashjoin3d_tpu/ops/chaining.py`` (``ChainingTable``,
``can_use_dense_direct``, ``build_chaining``, ``build_chaining_host``,
``_build_chaining_dense`` with its ``full_chain_index``,
``_build_chaining_fused``, ``_build_chaining_phase2``,
``_assemble_chaining``, ``shrink_chaining``, ``ChainProbeResult``,
``probe_chaining`` and ``materialize_chaining_join``).  Semantics of the
reference ``HtChaining1`` (``ht_chaining.hh``): a row's bucket is
``hash(key) % num_buckets``, the hash matched to the key width
(``murmur32`` / ``murmur64`` by default); each bucket's chain is
[first-inserted row, then the rest in reverse insertion order].

When the build keys are a permutation of [0, n) (exp-1's R.k) the probe
needs no directory: ``direct[key]`` packs ``row | (chain_pos + 1) <<
direct_shift``, so one lookup answers a probe and its early-exit
comparison count.  Probes without early exit (plan CsrUU) count whole
chains: ``chain_by_key[key]`` is the chain length of the key's bucket.

``build_chaining`` is the clarity build (the algebra's): n-sized
directories over every row, a ``valid`` mask, nothing read back.  Any
other key column of the host builds, u32 or u64, takes the compacted
build: the distinct-key directory (:class:`~.layout.GroupIndex`), the
bucket histogram and, for
early-exit probes, each key's first node in chain order
(``group_min_pos``, ``group_chain_first``).  Keys in a known domain
(exp-1's S.a, exp-4's FK columns) add the dense key -> group map
``key_direct``.  Without the early-exit index and with at most half as
many distinct keys as rows, the histogram comes from the directory
(cap-sized work) instead of a sort of every row's bucket.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..utils.tracing import host_read, span
from .chainwalk import bucket_ids, miss_chain_sum
from .hashing import hash_key_np
from .layout import (I32, I64, UKEY_PAD, GroupIndex, check_carrier,
                     compact_group_index, drop_pad_groups, emit_pos,
                     empty_group_index, expand, group_capacity, i64_to_u32,
                     inverse_permute, key_direct_index, key_direct_lookup,
                     key_group_index, lookup_auto, run_boundaries,
                     same_key_width, shrink_group_arrays, sort_with_rows,
                     sorted_histogram)


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
    with span("hj.build"):
        n = keys.shape[0]
        with span("hj.build.hash"):
            row = torch.arange(n, dtype=I32, device=keys.device)
            b = bucket_ids(keys, num_buckets, hashfun)
        with span("hj.build.sort"):
            b_sorted, srow = torch.sort(b, stable=True)
            srow = srow.to(I32)
        with span("hj.build.runs"):
            is_first_b, _, run_start_b, run_len_b = run_boundaries(b_sorted,
                                                                   n)
            bucket_start, bucket_len = sorted_histogram(
                b_sorted, num_buckets, is_first_b, run_len_b)
        chain_by_key = None
        if full_chain_index:
            with span("hj.build.hash"):
                chain_by_key = bucket_len[
                    bucket_ids(row, num_buckets, hashfun).long()]
        with span("hj.build.assemble"):
            rank = row - run_start_b
            # insertion rank 0 -> chain pos 0 (directory node); rank p > 0
            # -> len - p
            pos_sorted = torch.where(rank == 0, 0, run_len_b - rank)
            pos_by_row = inverse_permute(srow, pos_sorted)
            direct_shift = (n - 1).bit_length()
            packed = row.to(I64) | ((pos_by_row.to(I64) + 1) << direct_shift)
            direct = inverse_permute(keys, i64_to_u32(packed))
            empty = torch.zeros(0, dtype=I32, device=keys.device)
            return ChainingTable(
                bucket_start=bucket_start, bucket_len=bucket_len,
                pos_by_row=pos_by_row, keys=keys, direct=direct,
                direct_shift=direct_shift, num_buckets=num_buckets,
                hashfun=hashfun, chain_by_key=chain_by_key,
                groups=empty_group_index(n, keys.device),
                group_min_pos=empty, group_chain_first=empty)


def build_chaining(keys: torch.Tensor, num_buckets: int,
                   valid: torch.Tensor | None = None,
                   dense_direct: bool = False,
                   key_domain: int | None = None, hashfun: str = "murmur",
                   early_exit_index: bool = True) -> ChainingTable:
    """The clarity build: one table over every row, directories n-sized,
    nothing read back (``AlgHashJoinBuild::step``, ``algebra.hh:574-577``).

    ``valid`` marks the live rows; a dead row enters no bucket (parked past
    the last one) and joins no group.  A stable sort of the bucket ids
    gives each row its insertion rank in its bucket, the run structure
    (K3) the histogram and the chain positions; :func:`key_group_index`
    the directory.  The early-exit index is a scatter-min of chain
    positions over each key's rows (``group_min_pos``) and a scatter-max
    of the rows sitting there (``group_chain_first``: the bucket's head
    row, or the key's last-inserted row); dead rows land on group ``n - 1``
    with the neutral values ``n`` and -1.  ``dense_direct`` (permutation
    keys) adds the packed ``direct`` image, ``key_domain`` the key -> group
    map.
    """
    check_carrier(keys)
    n = keys.shape[0]
    dev = keys.device
    row = torch.arange(n, dtype=I32, device=dev)
    b = bucket_ids(keys, num_buckets, hashfun, live=valid)
    b_sorted, srow = torch.sort(b, stable=True)
    srow = srow.to(I32)
    vs = b_sorted < num_buckets
    is_first_b, _, run_start_b, run_len_b = run_boundaries(
        b_sorted, n if valid is None else vs.sum())
    bucket_start, bucket_len = sorted_histogram(b_sorted, num_buckets,
                                                is_first_b, run_len_b)
    rank = row - run_start_b
    # insertion rank 0 -> chain pos 0 (directory node); rank p > 0 -> len - p
    pos_sorted = torch.where(vs, torch.where(rank == 0, 0, run_len_b - rank),
                             n)
    empty = torch.zeros(0, dtype=I32, device=dev)
    pos_by_row = (inverse_permute(srow, pos_sorted)
                  if dense_direct or early_exit_index else empty)
    groups = key_group_index(keys, valid)

    group_min_pos = group_chain_first = empty
    if early_exit_index:
        gid_sorted = torch.where(vs, groups.gid_by_row[srow.long()],
                                 n - 1).long()
        group_min_pos = torch.full((n,), n, dtype=I32, device=dev)
        group_min_pos.scatter_reduce_(0, gid_sorted,
                                      torch.where(vs, pos_sorted, n),
                                      "amin", include_self=True)
        is_min = vs & (pos_sorted == group_min_pos[gid_sorted])
        group_chain_first = torch.full((n,), -1, dtype=I32, device=dev)
        group_chain_first.scatter_reduce_(0, gid_sorted,
                                          torch.where(is_min, srow, -1),
                                          "amax", include_self=True)

    direct = None
    direct_shift = 0
    if dense_direct:
        direct_shift = (n - 1).bit_length()
        packed = row.to(I64) | ((pos_by_row.to(I64) + 1) << direct_shift)
        direct = inverse_permute(keys, i64_to_u32(packed))
    key_direct = (key_direct_index(groups, key_domain)
                  if key_domain is not None and not dense_direct else None)
    return ChainingTable(bucket_start=bucket_start, bucket_len=bucket_len,
                         pos_by_row=pos_by_row, keys=keys, direct=direct,
                         direct_shift=direct_shift, num_buckets=num_buckets,
                         hashfun=hashfun, groups=groups,
                         group_min_pos=group_min_pos,
                         group_chain_first=group_chain_first,
                         key_direct=key_direct)


def build_chaining_host(keys: torch.Tensor, num_buckets: int,
                        dense_direct: bool = False,
                        n_keys: int | None = None,
                        key_domain: int | None = None,
                        early_exit_index: bool = True,
                        full_chain_index: bool = False,
                        hashfun: str = "murmur") -> ChainingTable:
    """Build a chaining table from a key column (the int32 carrier of u32
    keys, the int64 one of u64 keys) on its own device.

    Permutation keys (``dense_direct`` with ``n_keys == len(keys)``) take
    the slim dense build; ``full_chain_index`` adds ``chain_by_key`` there
    (plan CsrUU).  Otherwise the directory is compacted to ``cap =
    group_capacity(n_keys)`` entries: with ``n_keys`` given the build runs
    without reading anything back; without it the distinct count is read
    back once after the key sort.  ``key_domain`` adds ``key_direct``;
    ``early_exit_index=False`` (tables only probed without early exit:
    Crs, exp-4's Chj) leaves out the chain-position index.
    """
    check_carrier(keys)
    n = keys.shape[0]
    if dense_direct and n_keys == n:
        return _build_chaining_dense(keys, num_buckets,
                                     full_chain_index=full_chain_index,
                                     hashfun=hashfun)
    if n_keys is not None:
        return _build_chaining_fused(keys, group_capacity(n_keys, n),
                                     num_buckets, dense_direct, key_domain,
                                     early_exit_index, hashfun)
    with span("hj.build"):
        with span("hj.build.sort"):
            skey, srow, nk = sort_with_rows(keys)
            # the one host read
            cap = group_capacity(host_read(nk, "build.n_keys"), n)
        return _build_chaining_phase2(keys, skey, srow, cap, num_buckets,
                                      dense_direct, key_domain,
                                      early_exit_index, hashfun)


def _build_chaining_fused(keys: torch.Tensor, cap: int, num_buckets: int,
                          dense_direct: bool, key_domain: int | None = None,
                          early_exit_index: bool = True,
                          hashfun: str = "murmur", drop_pad_key: bool = False,
                          rows: torch.Tensor | None = None) -> ChainingTable:
    """The compacted build with a known capacity: phase-1 sort, then
    :func:`_build_chaining_phase2`, with no count read between them.
    ``rows`` (a distributed shard's global row ids, one a key) ride the
    phase-1 sort and become the emitted row ids; ``drop_pad_key`` kills
    the all-ones key's rows (see :func:`_build_chaining_phase2`)."""
    with span("hj.build"):
        with span("hj.build.sort"):
            skey, srow, _ = sort_with_rows(keys)
            rows_s = None if rows is None else rows.to(I32)[srow.long()]
        return _build_chaining_phase2(keys, skey, srow, cap, num_buckets,
                                      dense_direct, key_domain,
                                      early_exit_index, hashfun,
                                      drop_pad_key, rows_s)


def _build_chaining_phase2(keys: torch.Tensor, skey: torch.Tensor,
                           srow: torch.Tensor, cap: int, num_buckets: int,
                           dense_direct: bool, key_domain: int | None = None,
                           early_exit_index: bool = True,
                           hashfun: str = "murmur",
                           drop_pad_key: bool = False,
                           row_values: torch.Tensor | None = None
                           ) -> ChainingTable:
    """Directory, bucket histogram and chain-position index from the
    phase-1 sort.

    Without the early-exit index and with ``2 * cap <= n`` the histogram
    over rows is the per-bucket sum of the distinct keys' group sizes: one
    stable sort of the cap group buckets, their runs (K3) and an int64
    cumsum give each bucket's segment sum.  Otherwise every row's bucket
    is sorted; the early-exit index then takes each key's first node in
    chain order: the bucket's directory node (position 0) if the key owns
    it, else its last-inserted row (LIFO head insertion).

    ``drop_pad_key``: rows carrying the all-ones key are dead (a padded
    exchange receive): their group is zeroed
    (:func:`~.layout.drop_pad_groups`) and they enter no bucket.
    ``row_values`` (key-sorted) replaces the emitted ids of
    ``group_rows`` and ``group_chain_first`` (a shard's global rows);
    chain order still follows the local arrival positions.
    """
    with span("hj.build"):
        n = keys.shape[0]
        dev = keys.device
        with span("hj.build.runs"):
            groups = compact_group_index(keys, skey, srow, cap,
                                         row_values=row_values)
            empty = torch.zeros(0, dtype=I32, device=dev)
        if drop_pad_key:
            with span("hj.build.assemble"):
                groups = drop_pad_groups(groups)

        if not early_exit_index and 2 * cap <= n:
            with span("hj.build.hash"):
                validg = groups.group_len > 0
                b_g = bucket_ids(groups.ukey, num_buckets, hashfun,
                                 live=validg)
            with span("hj.build.sort"):
                bs, order = torch.sort(b_g, stable=True)
            with span("hj.build.runs"):
                bucket_start, bucket_len = _bucket_sums(
                    groups.group_len[order], bs, validg, cap, num_buckets)
            return _assemble_chaining(groups, bucket_start, bucket_len,
                                      empty, empty, empty, keys,
                                      num_buckets, dense_direct, key_domain,
                                      hashfun)

        with span("hj.build.hash"):
            row = torch.arange(n, dtype=I32, device=dev)
            b = bucket_ids(keys, num_buckets, hashfun)
            if drop_pad_key:
                # dead rows park past the last bucket, where the histogram
                # drops them
                b = torch.where(keys == UKEY_PAD, num_buckets, b)
        with span("hj.build.sort"):
            b_sorted, srow_b = torch.sort(b, stable=True)
        with span("hj.build.runs"):
            is_first_b, _, run_start_b, run_len_b = run_boundaries(b_sorted,
                                                                   n)
            bucket_start, bucket_len = sorted_histogram(
                b_sorted, num_buckets, is_first_b, run_len_b)
        if not early_exit_index or n == 0:
            return _assemble_chaining(groups, bucket_start, bucket_len,
                                      empty, empty, empty, keys,
                                      num_buckets, dense_direct, key_domain,
                                      hashfun)
        with span("hj.build.assemble"):
            rank = row - run_start_b
            pos_sorted = torch.where(rank == 0, 0, run_len_b - rank)
            pos_by_row = inverse_permute(srow_b.to(I32), pos_sorted)
            last = n - 1
            gs = torch.clamp(groups.group_start
                             + torch.clamp(groups.group_len - 1, min=0),
                             max=last)
            max_row = srow[gs.long()]  # rows ascend within a key run
            pos_first = pos_by_row[torch.clamp(groups.first_row,
                                               max=last).long()]
            pos_max = pos_by_row[torch.clamp(max_row, max=last).long()]
            head = pos_first == 0
            live = groups.group_len > 0
            group_min_pos = torch.where(live, torch.where(head, 0, pos_max),
                                        n)
            if row_values is None:
                first_emit, max_emit = groups.first_row, max_row
            else:
                # the same chosen rows in the emitted (global) coordinates
                first_emit = row_values[torch.clamp(groups.group_start,
                                                    max=last).long()]
                max_emit = row_values[gs.long()]
            group_chain_first = torch.where(
                live, torch.where(head, first_emit, max_emit), -1)
            return _assemble_chaining(groups, bucket_start, bucket_len,
                                      pos_by_row, group_min_pos.to(I32),
                                      group_chain_first.to(I32), keys,
                                      num_buckets, dense_direct, key_domain,
                                      hashfun)


def _bucket_sums(ls, bs, validg, cap: int, num_buckets: int):
    """``(bucket_start, bucket_len)`` of the rows from the group lengths
    ``ls`` in the order of their sorted buckets ``bs``: each bucket run's
    segment sum (K3 runs, an int64 cumsum)."""
    dev = bs.device
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
    return bucket_start, bucket_len


def _assemble_chaining(groups, bucket_start, bucket_len, pos_by_row,
                       group_min_pos, group_chain_first, keys, num_buckets,
                       dense_direct, key_domain, hashfun="murmur"):
    with span("hj.build.assemble"):
        n = keys.shape[0]
        direct = None
        direct_shift = 0
        if dense_direct:
            # permutation keys: cap == n, ukey[g] == g, singleton groups
            direct_shift = (n - 1).bit_length()
            direct = i64_to_u32(groups.first_row.to(I64)
                                | ((group_min_pos.to(I64) + 1)
                                   << direct_shift))
        key_direct = (key_direct_index(groups, key_domain)
                      if key_domain is not None and not dense_direct
                      else None)
        return ChainingTable(bucket_start=bucket_start,
                             bucket_len=bucket_len, pos_by_row=pos_by_row,
                             keys=keys, direct=direct,
                             direct_shift=direct_shift,
                             num_buckets=num_buckets, hashfun=hashfun,
                             groups=groups, group_min_pos=group_min_pos,
                             group_chain_first=group_chain_first,
                             key_direct=key_direct)


def shrink_chaining(table: ChainingTable, cap: int) -> ChainingTable:
    """Slice the directory (the group-indexed arrays) to ``cap`` entries,
    once the distinct count is known: probes then search O(n_keys)
    entries instead of O(n_rows) (:func:`~.layout.shrink_group_arrays`)."""
    g = table.groups
    ukey, gs, gl, fr = shrink_group_arrays(
        (g.ukey, g.group_start, g.group_len, g.first_row), cap)
    return replace(table,
                   groups=replace(g, ukey=ukey, group_start=gs,
                                  group_len=gl, first_row=fr),
                   group_min_pos=table.group_min_pos[:cap],
                   group_chain_first=table.group_chain_first[:cap])


@dataclass(frozen=True)
class ChainProbeResult:
    """Per-probe match descriptors and the plan counters."""

    g: torch.Tensor            # i32[P] candidate group (the build row itself
    #                                   when ``from_direct``)
    hit: torch.Tensor          # bool[P]
    match_count: torch.Tensor  # i32[P] tuples this probe emits
    num_matches: torch.Tensor  # i64[] total emitted tuples (c_htProbe)
    num_cmps: torch.Tensor     # i64[] chain comparisons (c_htProbeCmp)
    from_direct: bool = False


def _check_probe(table, pk: torch.Tensor) -> None:
    if pk.device != table.keys.device:
        raise ValueError(f"probe keys on {pk.device}, table on "
                         f"{table.keys.device}")
    same_key_width(table.keys, pk)


def _direct_probe(direct: torch.Tensor, shift: int, pk: torch.Tensor,
                  mask):
    """A dense-direct table's one gather: ``(in_range, hit, row, pos1)``;
    keys at or past ``n``, compared unsigned, are out of range."""
    n = direct.shape[0]
    in_range = (pk >= 0) & (pk < n)
    hit = in_range if mask is None else in_range & mask
    d = direct[torch.where(in_range, pk, n - 1).long()]
    row = d & ((1 << shift) - 1)
    pos1 = (d >> shift) & ((1 << (32 - shift)) - 1)
    return in_range, hit, row, pos1


def probe_chaining(table: ChainingTable, probe_keys: torch.Tensor,
                   unique: bool = False, mask: torch.Tensor | None = None,
                   method: str = "auto") -> ChainProbeResult:
    """Vectorized ``AlgHashJoinProbe`` (``algebra.hh:625-659``).

    ``unique`` is ``IsBuildKeyUnique``: the walk stops at the first
    matching node, so a probe emits at most one tuple and counts the
    match's chain position.  ``mask`` marks the live probe rows.  Four
    branches: a dense-direct table with and without ``unique`` (one gather
    of the packed word; without the early exit every live probe counts its
    bucket's chain), a ``key_direct`` table (one gather of the map) and a
    compacted table without one (:func:`~.layout.lookup_auto` with
    ``method``).  ``probe_keys`` ride the table's key carrier."""
    pk = probe_keys.contiguous()
    _check_probe(table, pk)
    live = (torch.ones_like(pk, dtype=torch.bool) if mask is None
            else mask.contiguous())

    if table.direct is not None:
        in_range, hit, row, pos1 = _direct_probe(
            table.direct, table.direct_shift, pk, mask)
        if unique:
            live_miss = live & ~in_range
            cmps = torch.where(hit, pos1, 0).to(I64).sum()
            if host_read(live_miss.any(), "miss.any"):
                cmps = cmps + miss_chain_sum(pk, live_miss, table.bucket_len,
                                             table.num_buckets, table.hashfun)
        else:
            # no early exit (CsrUU): every live probe walks its whole chain
            cmps = miss_chain_sum(pk, live, table.bucket_len,
                                  table.num_buckets, table.hashfun)
        return ChainProbeResult(g=row, hit=hit, match_count=hit.to(I32),
                                num_matches=hit.to(I64).sum(),
                                num_cmps=cmps, from_direct=True)

    if table.key_direct is not None:
        g, hit = key_direct_lookup(table.key_direct, pk)
    else:
        g, hit = lookup_auto(table.groups, pk, method)
    if mask is not None:
        hit = hit & mask
    gl = g.long()
    glen = torch.where(hit, table.groups.group_len[gl], 0)
    if unique:
        if table.group_min_pos.shape[0] == 0:
            raise ValueError(
                "table was built with early_exit_index=False; "
                "IsBuildKeyUnique probes need the chain-position index")
        cmps = (torch.where(hit, table.group_min_pos[gl] + 1, 0).to(I64).sum()
                + miss_chain_sum(pk, live & ~hit, table.bucket_len,
                                 table.num_buckets, table.hashfun))
        match_count = hit.to(I32)
    else:
        cmps = miss_chain_sum(pk, live, table.bucket_len, table.num_buckets,
                              table.hashfun)
        match_count = glen
    return ChainProbeResult(g=g, hit=hit, match_count=match_count,
                            num_matches=match_count.to(I64).sum(),
                            num_cmps=cmps)


def _clamped(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` with ``idx`` clamped into range (the JAX package's gather
    semantics; every caller masks the clamped slots)."""
    return a[torch.clamp(idx, 0, max(a.shape[0] - 1, 0)).long()]


def materialize_chaining_join(table: ChainingTable, probe: ChainProbeResult,
                              out_size: int, unique: bool = False,
                              sync_free: bool = False):
    """Expand probe matches into (probe_row, build_row) pairs in
    ``out_size`` slots (``algebra.hh:650-652``): ``(probe_row, build_row,
    valid, total)``, -1 in the dead slots, ``total`` an int64 device scalar
    (it may exceed ``out_size``: the pairs past it are cut).

    Three branches.  At most one match a probe (``unique``, or a
    dense-direct table): positional when ``out_size`` is the probe count,
    else compacted by a prefix sum and one scatter.  Otherwise the
    expansion (:func:`~.layout.expand`, K3 and K2) emits each group
    [first, rest LIFO]; when ``out_size`` is the probe count and no probe
    matches twice, the positional layout stands instead.  That choice
    reads the largest match count back once; ``sync_free`` computes both
    layouts and selects on the device.
    """
    P = probe.g.shape[0]
    dev = probe.g.device
    p = torch.arange(P, dtype=I32, device=dev)
    total = probe.match_count.to(I64).sum()
    if unique or probe.from_direct:
        # a dense permutation matches at most once, whatever ``unique`` says
        brow = (probe.g if probe.from_direct
                else _clamped(table.group_chain_first, probe.g))
        if out_size == P:
            return (torch.where(probe.hit, p, -1),
                    torch.where(probe.hit, brow, -1), probe.hit, total)
        cnt = probe.match_count
        off = torch.cumsum(cnt, 0, dtype=I32) - cnt
        # dropped probes (and pairs past the buffer) to slots of their own
        tgt = torch.where(probe.hit & (off < out_size), off,
                          out_size + p).long()
        probe_row = torch.full((out_size + P,), -1, dtype=I32, device=dev)
        build_row = torch.full((out_size + P,), -1, dtype=I32, device=dev)
        probe_row[tgt] = p
        build_row[tgt] = brow.to(I32)
        valid = torch.arange(out_size, dtype=I64, device=dev) < total
        return probe_row[:out_size], build_row[:out_size], valid, total

    groups = table.groups

    def expanded():
        gstart_by_probe = _clamped(groups.group_start, probe.g)
        q, within, valid, _, gstart, glen = expand(
            probe.match_count, out_size, (gstart_by_probe,),
            with_seg_len=True)
        brow = _clamped(groups.group_rows, gstart + emit_pos(within, glen))
        return (torch.where(valid, q, -1), torch.where(valid, brow, -1),
                valid)

    if out_size != P:
        return (*expanded(), total)

    def positional():
        hit1 = probe.match_count > 0
        brow = _clamped(groups.group_rows,
                        _clamped(groups.group_start, probe.g))
        return (torch.where(hit1, p, -1), torch.where(hit1, brow, -1), hit1)

    if P == 0:
        return (*positional(), total)
    if not sync_free:
        at_most_one = host_read(probe.match_count.max(), "expand.max") <= 1
        pick = positional if at_most_one else expanded
        return (*pick(), total)
    at_most_one = probe.match_count.max() <= 1
    out = tuple(torch.where(at_most_one, a, b)
                for a, b in zip(positional(), expanded()))
    return (*out, total)
