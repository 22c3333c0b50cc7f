"""Distributed hash joins over a device mesh.

Port of ``hashjoin3d_tpu/parallel/dist_join.py``.  SPMD, one process a
rank; each entry point returns a plain callable ``step(build_keys_local,
probe_keys_local) -> dict`` that every rank of the mesh calls with its
own block of each column (every rank the same block length):

  1. build side: ``partition_exchange`` routes build rows to the shard
     owning their key; each shard builds its table (chaining or 3D) over
     the receive, dead slots masked (or, with ``n_keys``, dropped by
     their all-ones key);
  2. probe side: probe rows route to the same shards and probe locally;
  3. the counters are summed over the mesh with one ``all_reduce`` of a
     stacked int64 vector, so every rank holds the same values; the
     result pairs stay on their shard, in *global* row ids (each row's
     id ``rank * n_local + i`` travels through the exchange as payload).

Result counters equal the single-chip engine's; ``num_cmps`` equals the
single-chip value of a table built in the exchange's arrival order (the
JAX package's, source rank by source rank), as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.chaining import (_build_chaining_fused, build_chaining,
                            materialize_chaining_join, probe_chaining)
from ..ops.hashing import bucket_of, hash_key
from ..ops.layout import I32, I64, UKEY_PAD, check_carrier, group_capacity
from ..ops.nested import _build_nested_fused, build_nested, probe_nested
from ..ops.nested import unnest
from ..ops.sort import window_for_chunk
from ..ops.strands_windowed import (keydirect_chaining_strand_sorted,
                                    keydirect_nested_strand_sorted,
                                    merged_chaining_strand_sorted,
                                    merged_nested_strand_sorted)
from .mesh import SHARD_AXIS, axis_info
from .shuffle import partition_exchange


def _global_rows(n_local: int, index: int, device) -> torch.Tensor:
    """Global ids of this rank's rows: block ``index`` of ``n_local``."""
    return index * n_local + torch.arange(n_local, dtype=I32, device=device)


def _reduce(groups, counters) -> list:
    """Sum the counters over the mesh: one stacked int64 vector, one
    ``all_reduce`` an axis group."""
    dev = next(c.device for c in counters if isinstance(c, torch.Tensor))
    vec = torch.stack([torch.as_tensor(c, dtype=I64, device=dev).reshape(())
                       for c in counters])
    for g in groups:
        dist.all_reduce(vec, group=g)
    return list(vec.unbind())


def _merged_pad_cmps(table, pkeys, pvalid, chain_len) -> torch.Tensor:
    """Comparisons of the exchange's dead receive slots on the merged
    strands: they carry the all-ones key and ride as ordinary misses,
    walking that key's bucket; the single-chip contract counts a masked
    probe as no comparison, so the walk is subtracted.  The port's
    streams reserve no pad key; this layer keeps its own."""
    pad = torch.full((1,), UKEY_PAD, dtype=pkeys.dtype, device=pkeys.device)
    pad_b = bucket_of(hash_key(pad, table.hashfun), table.num_buckets)
    n_dead = (~pvalid).sum(dtype=I64)
    return chain_len[pad_b.long()][0].to(I64) * n_dead


def _map_rows(ids, local, valid) -> torch.Tensor:
    """``ids[local]`` where ``valid``, else -1."""
    return torch.where(valid, ids[torch.clamp(local, min=0).long()], -1)


def _nested_table(bkeys, brows, bvalid, num_buckets, key_domain, n_keys):
    """A shard's 3D table over its build receive: the fused compacted
    build with global row ids and dead slots dropped by key (``n_keys``),
    else the clarity build under the receive's mask."""
    if n_keys is not None:
        cap = group_capacity(n_keys + 1, bkeys.shape[0])  # +1: pad group
        return _build_nested_fused(bkeys, cap, num_buckets, False,
                                   key_domain=key_domain, drop_pad_key=True,
                                   rows=brows)
    return build_nested(bkeys, num_buckets, valid=bvalid,
                        key_domain=key_domain)


def _chaining_table(bkeys, brows, bvalid, num_buckets, key_domain, n_keys,
                    unique):
    """A shard's chaining table (see :func:`_nested_table`); ``unique``
    builds the early-exit index."""
    if n_keys is not None:
        cap = group_capacity(n_keys + 1, bkeys.shape[0])  # +1: pad group
        return _build_chaining_fused(bkeys, cap, num_buckets, False,
                                     key_domain=key_domain,
                                     early_exit_index=unique,
                                     drop_pad_key=True, rows=brows)
    return build_chaining(bkeys, num_buckets, valid=bvalid,
                          key_domain=key_domain, early_exit_index=unique)


def _probe_nested_route(route, table, pkeys, prows, pvalid, out_capacity,
                        lookup_w=None):
    """One shard's nested probe and unnest: ``(probe_row (global),
    build_row (local or the table's emitted ids), valid, total, matches,
    cmps)``.  ``route``: "key_domain" (the presorted windowed strand over
    a key-sorted receive, global probe ids through ``srow_values``),
    "merged" (the merged windowed strand, dead slots' walks subtracted)
    or "default" (``probe_nested`` + ``unnest``)."""
    if route == "key_domain":
        out = keydirect_nested_strand_sorted(
            table, pkeys, out_capacity, mask=pvalid, presorted=True,
            srow_values=prows, lookup_w=lookup_w)
        prow = out["probe_row"]
        return (prow, out["build_row"], prow >= 0, out["c_unnest"],
                out["c_htProbe"], out["c_htProbeCmp"])
    if route == "merged":
        out = merged_nested_strand_sorted(table, pkeys, out_capacity)
        prow_l = out["probe_row"]
        ovalid = prow_l >= 0
        cmps = out["c_htProbeCmp"] - _merged_pad_cmps(
            table, pkeys, pvalid, table.bucket_main_len)
        return (_map_rows(prows, prow_l, ovalid), out["build_row"], ovalid,
                out["c_unnest"], out["c_htProbe"], cmps)
    res = probe_nested(table, pkeys, mask=pvalid)
    prow_l, brow_l, ovalid, total = unnest(table, res, out_capacity)
    return (_map_rows(prows, prow_l, ovalid), brow_l, ovalid, total,
            res.num_matches, res.num_cmps)


def _probe_chaining_route(route, table, pkeys, prows, pvalid, out_capacity,
                          unique, lookup_w=None):
    """One shard's chaining probe and materialisation (see
    :func:`_probe_nested_route`)."""
    if route == "key_domain":
        out = keydirect_chaining_strand_sorted(
            table, pkeys, out_capacity, unique=unique, mask=pvalid,
            presorted=True, srow_values=prows, lookup_w=lookup_w)
        prow = out["probe_row"]
        return (prow, out["build_row"], prow >= 0, out["total"],
                out["c_htProbe"], out["c_htProbeCmp"])
    if route == "merged":
        out = merged_chaining_strand_sorted(table, pkeys, out_capacity,
                                            unique=unique)
        prow_l = out["probe_row"]
        ovalid = prow_l >= 0
        cmps = out["c_htProbeCmp"] - _merged_pad_cmps(
            table, pkeys, pvalid, table.bucket_len)
        return (_map_rows(prows, prow_l, ovalid), out["build_row"], ovalid,
                out["total"], out["c_htProbe"], cmps)
    res = probe_chaining(table, pkeys, unique=unique, mask=pvalid)
    prow_l, brow_l, ovalid, total = materialize_chaining_join(
        table, res, out_capacity, unique=unique)
    return (_map_rows(prows, prow_l, ovalid), brow_l, ovalid, total,
            res.num_matches, res.num_cmps)


def _route(key_domain, merged, probe_keys) -> str:
    """The shard-local probe route: ``key_domain`` takes the presorted
    windowed strand; ``merged`` (default: 64-bit keys without a key
    domain) the merged strand; else the probe ops."""
    if key_domain is not None:
        return "key_domain"
    use_merged = (merged if merged is not None
                  else probe_keys.dtype == I64)
    return "merged" if use_merged else "default"


def _check_columns(*cols) -> None:
    for c in cols:
        check_carrier(c)
    if cols[0].dtype != cols[1].dtype:
        raise ValueError(f"build keys ride {cols[0].dtype}, probe keys "
                         f"{cols[1].dtype}: widen both to one key width")


def dist_nested_join(mesh, num_buckets_per_shard: int, build_capacity: int,
                     probe_capacity: int, out_capacity: int,
                     axis: str = SHARD_AXIS, key_domain: int | None = None,
                     n_keys: int | None = None, merged: bool | None = None):
    """A distributed 3D-hash-join step over ``mesh``'s ``axis``.

    ``step(build_keys, probe_keys) -> dict``, called by every rank with
    its block of each key column (carriers on the mesh's device), returns
    the global counters on every rank (``num_matches``, ``num_cmps``,
    ``num_unnested``, ``overflow``: int64 device scalars) and this
    shard's ``out_capacity`` (``probe_row``, ``build_row``) global-id
    pairs with their ``out_valid`` mask.

    ``key_domain`` (a bound on key values + 1) takes the windowed sorted
    strand per shard: the probe exchange orders keys within each
    destination (``sort_within_dest``), the receive is probed presorted
    with its block spread's window, and the global probe ids ride the
    strand's ``srow`` lookup.  ``n_keys`` (a bound on distinct keys
    received per shard) takes the fused compacted build: directories of
    ~``n_keys`` entries, dead slots dropped by their all-ones key, the
    global build ids riding the build sort.  ``merged`` takes the merged
    windowed strand (the route for u64, composite and sparse keys; by
    default on for 64-bit keys without ``key_domain``); the dead slots'
    walks are subtracted (:func:`_merged_pad_cmps`).
    """
    group, ns, index = axis_info(mesh, axis)

    def step(build_keys, probe_keys):
        _check_columns(build_keys, probe_keys)
        dev = build_keys.device
        route = _route(key_domain, merged, probe_keys)
        bkeys, bpay, bvalid, bovf = partition_exchange(
            group, build_keys,
            {"row": _global_rows(build_keys.shape[0], index, dev)}, ns,
            build_capacity, reduce_overflow=False)
        table = _nested_table(bkeys, bpay["row"], bvalid,
                              num_buckets_per_shard, key_domain, n_keys)
        pkeys, ppay, pvalid, povf = partition_exchange(
            group, probe_keys,
            {"row": _global_rows(probe_keys.shape[0], index, dev)}, ns,
            probe_capacity, sort_within_dest=route == "key_domain",
            reduce_overflow=False)
        # the receive is ns sorted blocks of probe_capacity rows, each
        # spanning the key domain: the window covers the block spread
        lookup_w = (window_for_chunk(probe_capacity, key_domain)
                    if route == "key_domain" else None)
        probe_row, brow, ovalid, total, n_matches, n_cmps = (
            _probe_nested_route(route, table, pkeys, ppay["row"], pvalid,
                                out_capacity, lookup_w))
        build_row = (torch.where(ovalid, brow, -1) if n_keys is not None
                     else _map_rows(bpay["row"], brow, ovalid))
        nm, nc, nu, ovf = _reduce([group], [n_matches, n_cmps, total,
                                            bovf + povf])
        return dict(num_matches=nm, num_cmps=nc, num_unnested=nu,
                    overflow=ovf, probe_row=probe_row, build_row=build_row,
                    out_valid=ovalid)

    return step


def dist_chaining_join(mesh, num_buckets_per_shard: int,
                       build_capacity: int, probe_capacity: int,
                       out_capacity: int, unique: bool = False,
                       axis: str = SHARD_AXIS, key_domain: int | None = None,
                       n_keys: int | None = None,
                       merged: bool | None = None):
    """Distributed chaining hash join (see :func:`dist_nested_join`):
    ``num_results`` in place of ``num_unnested``; ``unique`` is
    IsBuildKeyUnique (the early-exit probe; with ``n_keys`` the fused
    build's early-exit index emits global chain heads)."""
    group, ns, index = axis_info(mesh, axis)

    def step(build_keys, probe_keys):
        _check_columns(build_keys, probe_keys)
        dev = build_keys.device
        route = _route(key_domain, merged, probe_keys)
        bkeys, bpay, bvalid, bovf = partition_exchange(
            group, build_keys,
            {"row": _global_rows(build_keys.shape[0], index, dev)}, ns,
            build_capacity, reduce_overflow=False)
        table = _chaining_table(bkeys, bpay["row"], bvalid,
                                num_buckets_per_shard, key_domain, n_keys,
                                unique)
        pkeys, ppay, pvalid, povf = partition_exchange(
            group, probe_keys,
            {"row": _global_rows(probe_keys.shape[0], index, dev)}, ns,
            probe_capacity, sort_within_dest=route == "key_domain",
            reduce_overflow=False)
        lookup_w = (window_for_chunk(probe_capacity, key_domain)
                    if route == "key_domain" else None)
        probe_row, brow, ovalid, total, n_matches, n_cmps = (
            _probe_chaining_route(route, table, pkeys, ppay["row"], pvalid,
                                  out_capacity, unique, lookup_w))
        build_row = (torch.where(ovalid, brow, -1) if n_keys is not None
                     else _map_rows(bpay["row"], brow, ovalid))
        nm, nc, nr, ovf = _reduce([group], [n_matches, n_cmps, total,
                                            bovf + povf])
        return dict(num_matches=nm, num_cmps=nc, num_results=nr,
                    overflow=ovf, probe_row=probe_row, build_row=build_row,
                    out_valid=ovalid)

    return step


class _Appender:
    """Result pairs of several probe steps appended into one
    ``out_capacity`` buffer at a running device offset.  Each step's
    valid rows are a prefix of its ``step_cap`` slots; pairs past the
    buffer are counted as overflow, as are a step's pairs past its own
    ``step_cap`` (an unnest reports its true total but materialises at
    most ``step_cap``), so truncation never leaves (-1, -1) rows marked
    valid."""

    def __init__(self, out_capacity: int, step_cap: int, device):
        self.cap, self.step_cap = out_capacity, step_cap
        self.probe_row = torch.full((out_capacity + step_cap,), -1,
                                    dtype=I32, device=device)
        self.build_row = torch.full_like(self.probe_row, -1)
        self.offset = torch.zeros((), dtype=I64, device=device)
        self.step_dropped = torch.zeros((), dtype=I64, device=device)
        self._j = torch.arange(step_cap, dtype=I64, device=device)

    def add(self, prow_g, brow_g, ovalid, total) -> None:
        pos = self.offset + torch.cumsum(ovalid.to(I64), 0) - 1
        keep = ovalid & (pos < self.cap)
        tgt = torch.where(keep, pos, self.cap + self._j)
        self.probe_row[tgt] = torch.where(ovalid, prow_g, -1).to(I32)
        self.build_row[tgt] = torch.where(ovalid, brow_g, -1).to(I32)
        materialized = torch.clamp(total.to(I64), max=self.step_cap)
        self.offset = self.offset + materialized
        self.step_dropped = self.step_dropped + (total.to(I64)
                                                 - materialized)

    def finish(self):
        """``(probe_row, build_row, out_valid, dropped)``."""
        dropped = torch.clamp(self.offset - self.cap, min=0) + \
            self.step_dropped
        out_valid = (torch.arange(self.cap, dtype=I64,
                                  device=self.offset.device)
                     < torch.clamp(self.offset, max=self.cap))
        return (self.probe_row[:self.cap], self.build_row[:self.cap],
                out_valid, dropped)


def dist_nested_join_chunked(mesh, num_buckets_per_shard: int,
                             build_capacity: int, probe_capacity: int,
                             out_capacity: int, n_chunks: int,
                             step_out_capacity: int | None = None,
                             axis: str = SHARD_AXIS, prefetch: bool = True):
    """Chunked flat join: the exchange of probe chunk i+1 overlaps the
    probe of chunk i.

    The results contract of :func:`dist_nested_join` (its default route),
    with the local probe column split into ``n_chunks`` chunks exchanged
    and probed in a software pipeline: with ``prefetch`` chunk i+1's
    collectives are issued asynchronously (``async_op``) before chunk i's
    probe and waited on just before chunk i+1 is read, so on the GPU the
    all-to-all runs on its own stream beside the probe.
    ``probe_capacity`` bounds received rows per (source, destination,
    chunk); ``step_out_capacity`` one chunk's unnested output (default
    ``out_capacity // n_chunks``); pairs cut by either count as overflow.
    """
    group, ns, index = axis_info(mesh, axis)
    step_cap = (out_capacity // n_chunks if step_out_capacity is None
                else step_out_capacity)

    def step(build_keys, probe_keys):
        _check_columns(build_keys, probe_keys)
        dev = build_keys.device
        np_local = probe_keys.shape[0]
        if np_local % n_chunks:
            raise ValueError(f"{np_local} probe rows do not split into "
                             f"{n_chunks} chunks")
        cn = np_local // n_chunks
        bkeys, bpay, bvalid, bovf = partition_exchange(
            group, build_keys,
            {"row": _global_rows(build_keys.shape[0], index, dev)}, ns,
            build_capacity, reduce_overflow=False)
        table = build_nested(bkeys, num_buckets_per_shard, valid=bvalid)
        rows = _global_rows(np_local, index, dev)

        def xchg(i, async_op):
            sl = slice(i * cn, (i + 1) * cn)
            return partition_exchange(group, probe_keys[sl],
                                      {"row": rows[sl]}, ns, probe_capacity,
                                      reduce_overflow=False,
                                      async_op=async_op)

        out = _Appender(out_capacity, step_cap, dev)
        counts = torch.zeros(4, dtype=I64, device=dev)  # m, cmps, nu, povf
        state = xchg(0, False)
        for i in range(n_chunks):
            nxt = (xchg(i + 1, True) if prefetch and i + 1 < n_chunks
                   else None)  # issued before this chunk's probe
            pkeys, ppay, pvalid, povf_i = state
            res = probe_nested(table, pkeys, mask=pvalid)
            prow_l, brow_l, ovalid, total = unnest(table, res, step_cap)
            out.add(_map_rows(ppay["row"], prow_l, ovalid),
                    _map_rows(bpay["row"], brow_l, ovalid), ovalid, total)
            counts += torch.stack([res.num_matches.to(I64),
                                   res.num_cmps.to(I64), total.to(I64),
                                   povf_i])
            if i + 1 < n_chunks:
                state = nxt.wait() if prefetch else xchg(i + 1, False)
        probe_row, build_row, out_valid, dropped = out.finish()
        nm, nc, nu, ovf = _reduce([group], [*counts[:3],
                                            bovf + counts[3] + dropped])
        return dict(num_matches=nm, num_cmps=nc, num_unnested=nu,
                    overflow=ovf, probe_row=probe_row, build_row=build_row,
                    out_valid=out_valid)

    return step
