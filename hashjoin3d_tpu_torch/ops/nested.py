"""Nested ("3D") hash table: the dense-direct and the compacted builds.

Port of ``hashjoin3d_tpu/ops/nested.py`` (``NestedTable``,
``can_use_dense_direct``, ``build_nested``, ``build_nested_host``,
``_build_nested_dense``, ``_build_nested_fused``, ``_build_nested_phase2``,
``shrink_nested``, ``NestedBatch``, ``probe_nested``, ``unnest`` and
``deferred_two_join_strand``).  Semantics of the
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
``build_nested`` is the clarity build: the n-sized directory of
``key_group_index`` over every row, a ``valid`` mask, nothing read back.
``unnest`` expands nested tuples ([first-inserted row, the rest LIFO])
with ``expand``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..utils.tracing import host_read, span
from .chaining import _check_probe, _clamped, _direct_probe, _nbytes
from .chaining import can_use_dense_direct as _chaining_dense_ok
from .hashing import bucket_of, hash_key
from .layout import (I32, I64, GroupIndex, check_carrier,
                     compact_group_index, drop_pad_groups, emit_pos,
                     empty_group_index, expand, group_capacity, i64_to_u32,
                     inverse_permute, key_direct_index, key_direct_lookup,
                     key_group_index, lookup_auto, run_boundaries,
                     shrink_group_arrays, sort_with_rows, sorted_histogram)


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


def _main_chains(groups: GroupIndex, num_buckets: int, hashfun):
    """``(main_pos_by_group, bucket_main_len)`` of a directory: the groups
    sort by (bucket, first row), one stable sort of the two packed in an
    int64 word with the padding groups parked at bucket ``num_buckets``, so
    within a bucket they stand in first-occurrence order (tail append,
    ``ht_nested.hh:299-308``) and a group's main-chain position is its rank
    in its bucket's run."""
    cap = groups.ukey.shape[0]
    with span("hj.build.hash"):
        validg = groups.group_len > 0
        b_main = torch.where(validg,
                             bucket_of(hash_key(groups.ukey, hashfun),
                                       num_buckets), num_buckets)
    with span("hj.build.sort"):
        # first_row <= n < 2^31 and b_main <= num_buckets < 2^31: both fit
        packed = (b_main.to(I64) << 32) | groups.first_row.to(I64)
        pk_s, gid_s = torch.sort(packed, stable=True)
        bm_s = (pk_s >> 32).to(I32)
    with span("hj.build.runs"):
        is_first_m, _, run_start, run_len_m = run_boundaries(
            bm_s, validg.sum(dtype=I32))
        _, bucket_main_len = sorted_histogram(bm_s, num_buckets, is_first_m,
                                              run_len_m)
    with span("hj.build.assemble"):
        pos_s = torch.arange(cap, dtype=I32, device=bm_s.device) - run_start
        return inverse_permute(gid_s.to(I32), pos_s), bucket_main_len


def build_nested(keys: torch.Tensor, num_buckets: int,
                 valid: torch.Tensor | None = None,
                 dense_direct: bool = False, key_domain: int | None = None,
                 hashfun: str = "murmur") -> NestedTable:
    """The clarity 3D build: the n-sized directory of
    :func:`~.layout.key_group_index` (``valid`` marks the live rows; a dead
    row joins no group), each group's main-chain position and each bucket's
    main-chain length, nothing read back (``AlgNestJoinBuild::step``,
    ``algebra.hh:386-389``).  ``dense_direct`` (permutation keys) adds the
    packed ``direct`` image, ``key_domain`` the key -> group map."""
    check_carrier(keys)
    with span("hj.build"):
        n = keys.shape[0]
        with span("hj.build.runs"):
            groups = key_group_index(keys, valid)
        main_pos_by_group, bucket_main_len = _main_chains(groups,
                                                          num_buckets,
                                                          hashfun)
        with span("hj.build.assemble"):
            direct = None
            direct_shift = 0
            if dense_direct:
                # permutation keys: ukey[i] == i, one row a group, key ==
                # group id
                direct_shift = (n - 1).bit_length()
                row = torch.arange(n, dtype=I64, device=keys.device)
                pos1 = main_pos_by_group[keys.long()].to(I64) + 1
                direct = inverse_permute(
                    keys, i64_to_u32(row | (pos1 << direct_shift)))
            key_direct = (key_direct_index(groups, key_domain)
                          if key_domain is not None and not dense_direct
                          else None)
            return NestedTable(groups=groups,
                               main_pos_by_group=main_pos_by_group,
                               bucket_main_len=bucket_main_len, keys=keys,
                               num_buckets=num_buckets, direct=direct,
                               direct_shift=direct_shift,
                               key_direct=key_direct, hashfun=hashfun)


def build_nested_host(keys: torch.Tensor, num_buckets: int,
                      dense_direct: bool = False, n_keys: int | None = None,
                      key_domain: int | None = None,
                      hashfun: str = "murmur") -> NestedTable:
    """Build the 3D table from a key column (the int32 carrier of u32
    keys, the int64 one of u64 keys) on its own device.

    Permutation keys (``dense_direct`` with ``n_keys == len(keys)``) take
    the slim dense build.  Otherwise the directory is compacted to
    ``cap = group_capacity(n_keys)`` entries: with ``n_keys`` given (the
    harness knows each column's distinct count) sort and directory run
    without reading the count back; without it the count is read back
    once after the sort.  A smaller ``n_keys`` than the true count
    truncates the directory.  ``key_domain`` adds the dense key -> group map.
    """
    check_carrier(keys)
    if dense_direct and n_keys == keys.shape[0]:
        return _build_nested_dense(keys, num_buckets, hashfun)
    if n_keys is not None:
        cap = group_capacity(n_keys, keys.shape[0])
        return _build_nested_fused(keys, cap, num_buckets, dense_direct,
                                   key_domain, hashfun)
    with span("hj.build"):
        with span("hj.build.sort"):
            skey, srow, nk = sort_with_rows(keys)
            # the one host read
            cap = group_capacity(host_read(nk, "build.n_keys"),
                                 keys.shape[0])
        return _build_nested_phase2(keys, skey, srow, cap, num_buckets,
                                    dense_direct, key_domain, hashfun)


def _build_nested_dense(keys: torch.Tensor, num_buckets: int,
                        hashfun: str = "murmur") -> NestedTable:
    """Dense-direct 3D build: every row is its own MainNode, and its
    main-chain position is its ARRIVAL rank in its bucket (tail append)."""
    with span("hj.build"):
        n = keys.shape[0]
        with span("hj.build.hash"):
            row = torch.arange(n, dtype=I32, device=keys.device)
            b = bucket_of(hash_key(keys, hashfun), num_buckets)
        with span("hj.build.sort"):
            b_sorted, srow = torch.sort(b, stable=True)
        with span("hj.build.runs"):
            is_first_b, _, run_start_b, run_len_b = run_boundaries(b_sorted,
                                                                   n)
            _, bucket_main_len = sorted_histogram(b_sorted, num_buckets,
                                                  is_first_b, run_len_b)
        with span("hj.build.assemble"):
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
                        hashfun: str = "murmur", drop_pad_key: bool = False,
                        rows: torch.Tensor | None = None) -> NestedTable:
    """The compacted build with a known capacity: phase-1 sort, then
    :func:`_build_nested_phase2`, with no count read between them.
    ``rows`` (a distributed shard's global row ids) ride the phase-1 sort
    and become ``group_rows``; ``drop_pad_key`` kills the all-ones key's
    rows."""
    with span("hj.build"):
        with span("hj.build.sort"):
            skey, srow, _ = sort_with_rows(keys)
            rows_s = None if rows is None else rows.to(I32)[srow.long()]
        return _build_nested_phase2(keys, skey, srow, cap, num_buckets,
                                    dense_direct, key_domain, hashfun,
                                    drop_pad_key, rows_s)


def _build_nested_phase2(keys: torch.Tensor, skey: torch.Tensor,
                         srow: torch.Tensor, cap: int, num_buckets: int,
                         dense_direct: bool, key_domain: int | None = None,
                         hashfun: str = "murmur", drop_pad_key: bool = False,
                         row_values: torch.Tensor | None = None
                         ) -> NestedTable:
    """Directory (``cap`` entries), main chains (:func:`_main_chains`) and
    indexes from the phase-1 sort.  ``drop_pad_key``: rows on the
    all-ones key are dead (a padded exchange receive), their group
    zeroed (:func:`~.layout.drop_pad_groups`), so they enter no main
    chain and match nothing.  ``row_values`` (key-sorted) replaces the
    emitted ``group_rows``."""
    with span("hj.build"):
        n = keys.shape[0]
        with span("hj.build.runs"):
            groups = compact_group_index(keys, skey, srow, cap,
                                         row_values=row_values)
        if drop_pad_key:
            with span("hj.build.assemble"):
                groups = drop_pad_groups(groups)
        main_pos_by_group, bucket_main_len = _main_chains(groups,
                                                          num_buckets,
                                                          hashfun)
        with span("hj.build.assemble"):
            direct = None
            direct_shift = 0
            if dense_direct:
                # permutation keys: cap == n, ukey[g] == g, singleton groups
                direct_shift = (n - 1).bit_length()
                direct = i64_to_u32(groups.first_row.to(I64)
                                    | ((main_pos_by_group.to(I64) + 1)
                                       << direct_shift))
            key_direct = (key_direct_index(groups, key_domain)
                          if key_domain is not None and not dense_direct
                          else None)
            return NestedTable(groups=groups,
                               main_pos_by_group=main_pos_by_group,
                               bucket_main_len=bucket_main_len, keys=keys,
                               num_buckets=num_buckets, direct=direct,
                               direct_shift=direct_shift,
                               key_direct=key_direct, hashfun=hashfun)


def shrink_nested(table: NestedTable, cap: int) -> NestedTable:
    """Slice the main-node directory to ``cap`` entries (see
    :func:`~.chaining.shrink_chaining`)."""
    g = table.groups
    ukey, gs, gl, fr = shrink_group_arrays(
        (g.ukey, g.group_start, g.group_len, g.first_row), cap)
    return replace(table,
                   groups=replace(g, ukey=ukey, group_start=gs,
                                  group_len=gl, first_row=fr),
                   main_pos_by_group=table.main_pos_by_group[:cap])


@dataclass(frozen=True)
class NestedBatch:
    """A batch of nested tuples, the vectorized ``(probe*, MainNode*)``
    pair: ``probe_row[i]`` (positional, ``arange(P)``) pairs with group
    ``g[i]`` where ``hit[i]`` (``algebra.hh:451-458``)."""

    probe_row: torch.Tensor    # i32[P]
    g: torch.Tensor            # i32[P]
    hit: torch.Tensor          # bool[P]
    group_len: torch.Tensor    # i32[P] (0 where no hit)
    num_matches: torch.Tensor  # i64[] probes with a match
    num_cmps: torch.Tensor     # i64[] main-chain comparisons
    #: i32[P] the single matching build row (dense-direct tables)
    direct_row: torch.Tensor | None = None


def probe_nested(table: NestedTable, probe_keys: torch.Tensor,
                 mask: torch.Tensor | None = None,
                 method: str = "auto") -> NestedBatch:
    """Vectorized ``AlgNestJoinProbe`` (``algebra.hh:435-459``): at most
    one nested tuple per live probe row, counting the matching MainNode's
    1-based main-chain position, or the whole main chain on a miss.  A
    dense-direct table answers with one gather of the packed word; a
    compacted one through ``key_direct`` (one gather) or
    :func:`~.layout.lookup_auto` with ``method``.  ``probe_keys`` ride
    the table's key carrier."""
    pk = probe_keys
    _check_probe(table, pk)
    P = pk.shape[0]
    rows = torch.arange(P, dtype=I32, device=pk.device)

    def main_len_of(keys):
        return table.bucket_main_len[bucket_of(
            hash_key(keys, table.hashfun), table.num_buckets).long()]

    if table.direct is not None:
        n = table.direct.shape[0]
        in_range, hit, row, pos1 = _direct_probe(
            table.direct, table.direct_shift, pk, mask)
        cmps = torch.where(hit, pos1, 0).to(I64).sum()
        live_miss = ~in_range if mask is None else mask & ~in_range
        if host_read(live_miss.any(), "miss.any"):
            cmps = cmps + torch.where(live_miss, main_len_of(pk),
                                      0).to(I64).sum()
        return NestedBatch(probe_row=rows,
                           g=torch.where(in_range, pk, n - 1).to(I32),
                           hit=hit, group_len=hit.to(I32),
                           num_matches=hit.to(I64).sum(), num_cmps=cmps,
                           direct_row=row)

    if table.key_direct is not None:
        g, hit = key_direct_lookup(table.key_direct, pk)
    else:
        g, hit = lookup_auto(table.groups, pk, method)
    if mask is not None:
        hit = hit & mask
    gl = g.long()
    cmps = torch.where(hit, table.main_pos_by_group[gl] + 1, main_len_of(pk))
    if mask is not None:
        cmps = torch.where(mask, cmps, 0)
    return NestedBatch(probe_row=rows, g=g, hit=hit,
                       group_len=torch.where(hit, table.groups.group_len[gl],
                                             0),
                       num_matches=hit.to(I64).sum(),
                       num_cmps=cmps.to(I64).sum())


def unnest(table: NestedTable, nested: NestedBatch, out_size: int):
    """Vectorized ``AlgUnnestHt`` (``algebra.hh:510-541``): one output row
    per duplicate of each nested tuple's group, [first-inserted row, the
    rest LIFO], in ``out_size`` slots.  Returns ``(probe_row, build_row,
    valid, total)``, -1 in the dead slots, ``total`` an int64 device scalar
    (the unnest's ``_count``; pairs past ``out_size`` are cut).

    A batch from a dense-direct table (``direct_row``: singleton groups)
    unnests positionally when ``out_size`` is its length; otherwise the
    expansion (K3, K2) carries each tuple's group start, and the segment
    index it yields is the probe row (``probe_row`` is ``arange(P)``).
    """
    P = nested.g.shape[0]
    if nested.direct_row is not None and out_size == P:
        total = nested.hit.to(I64).sum()
        return (torch.where(nested.hit, nested.probe_row, -1),
                torch.where(nested.hit, nested.direct_row, -1), nested.hit,
                total)
    groups = table.groups
    p, within, valid, total, gstart, glen = expand(
        nested.group_len, out_size, (_clamped(groups.group_start, nested.g),),
        with_seg_len=True)
    build_row = _clamped(groups.group_rows, gstart + emit_pos(within, glen))
    return (torch.where(valid, p, -1), torch.where(valid, build_row, -1),
            valid, total.to(I64))


def deferred_two_join_strand(tbl_s: NestedTable, tbl_t: NestedTable,
                             keys: torch.Tensor, out1: int, out2: int,
                             mask: torch.Tensor | None = None) -> dict:
    """Probe S, probe T under the S hits, unnest T, then S: exp-4's Ndu
    strand (``main_experiment4.cc:832-941``).  The nested tuples cross the
    second probe unexpanded, so both expansions run only for rows that
    survived both joins; each segment's attributes ride the expansions as
    payloads.  Returns ``r_row`` / ``s_row`` / ``t_row`` (-1 in the dead
    slots), ``valid``, both probes' counters and both unnest counts
    (``c_unnest_1`` T's, ``c_unnest_2`` S's), int64."""
    rs = probe_nested(tbl_s, keys, mask=mask)
    rst = probe_nested(tbl_t, keys, mask=rs.hit)
    both = rst.hit
    gt, gs = tbl_t.groups, tbl_s.groups
    p1, w1, v1, n_unnest1, gst_t, gs1, tlen1 = expand(
        torch.where(both, rst.group_len, 0), out1,
        (_clamped(gt.group_start, rst.g), torch.where(both, rs.g, 0)),
        with_seg_len=True)
    t_row = _clamped(gt.group_rows, gst_t + emit_pos(w1, tlen1))
    _, w2, v2, n_unnest2, gst_s, t_prop, r_prop, slen2 = expand(
        torch.where(v1, _clamped(gs.group_len, gs1), 0), out2,
        (_clamped(gs.group_start, gs1), torch.where(v1, t_row, 0),
         torch.where(v1, p1, 0)),
        with_seg_len=True)
    s_row = _clamped(gs.group_rows, gst_s + emit_pos(w2, slen2))
    return dict(
        r_row=torch.where(v2, r_prop, -1), s_row=torch.where(v2, s_row, -1),
        t_row=torch.where(v2, t_prop, -1), valid=v2,
        c_probe_RS=rs.num_matches, c_probe_RS_cmp=rs.num_cmps,
        c_probe_RT=rst.num_matches, c_probe_RT_cmp=rst.num_cmps,
        c_unnest_1=n_unnest1.to(I64), c_unnest_2=n_unnest2.to(I64))
