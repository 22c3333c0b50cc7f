"""The sorted windowed probe strands of the exp-1 and exp-4 device plans.

Port of ``hashjoin3d_tpu/ops/strands_windowed.py``: the dense-direct strand
of plans Csr, CsrUU, Nsr and CsrSel, the key_direct nested strand of plans
Nrs, NrsNU and NrsSel, the key_direct chaining strand of plans Crs and
CrsSel, exp-4's Ndu, Chj and Nnu strands, and the merged nested and
chaining strands of ``api.join``'s u64, composite and sparse keys (group
ids from one sort-merge of the directory and the probes, kept in merged
order so every later access stays a windowed lookup).  Probes are sorted once
(segmented, K1 / K4), or not at all for a permutation or an iota probe
column, or globally with their liveness riding the sort under a selection
``mask``; every per-key and per-group array is then read by one windowed
lookup (K2) on a nondecreasing stream, the unnest expansions scan with K3,
and missing probes walk their bucket chains through a second sorted stream
(K4).  Emission is in sorted-key order; result pairs (exp-4: triples)
equal the reference's as multisets and the counters (c_htProbe,
c_htProbeCmp, c_unnest, c_top, exp-4's c_probe_*) are bit-equal.

The JAX ``lax.cond`` / ``lax.switch`` routes are Python branches here, each
on one value read back from the device.  Every :func:`safe_lookup` inside a
strand records its route (0 windowed, 1 patched, 2 gather) and the strand
reports the worst as ``route_worst`` (and ``route_nbad``).  Route 2 is part
of the semantics, not a device fallback: an uncoverable stream is still
answered exactly, by a plain gather.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .bitonic import MAX_SEGMENT_BITONIC, bitonic_sort_packed_segmented
from .hashing import bucket_of, hash_key
from .layout import (I32, I64, SIGN, expand, inverse_permute,
                     is_sorted_ascending, same_key_width, shr, uorder)
from .sort import (probe_sort_chunk, sort_segmented, sort_segmented_1op,
                   window_for_chunk)
from ..utils.tracing import host_read, span
from .windowed import DEFAULT_C, DEFAULT_W, windowed_lookup_covered

ROUTE_WINDOWED, ROUTE_PATCHED, ROUTE_GATHER = 0, 1, 2

# One record list per running strand; safe_lookup appends (route, nbad).
# A None entry suppresses recording (the miss walk's lookup, as in the JAX
# package, where it sits inside a cond branch).
_route_records: list = []


def _record_route(route: int, nbad: int) -> None:
    if _route_records and _route_records[-1] is not None:
        _route_records[-1].append((route, nbad))


class _suppress_routes:
    def __enter__(self):
        _route_records.append(None)

    def __exit__(self, *exc):
        _route_records.pop()


def _with_route(fn):
    """Add ``route_worst`` / ``route_nbad`` (max over the strand's
    safe_lookups) to a strand's output dict; the strand runs in the
    ``hj.probe`` span."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        _route_records.append([])
        try:
            with span("hj.probe"):
                out = fn(*args, **kwargs)
        finally:
            rec = _route_records.pop()
        out = dict(out)
        out["route_worst"] = max((r for r, _ in rec), default=ROUTE_WINDOWED)
        out["route_nbad"] = max((b for _, b in rec), default=0)
        return out

    return wrapper


def _pad_table(arr: torch.Tensor, W: int = DEFAULT_W) -> torch.Tensor:
    """Zero-pad to the windowed kernel's size rule (>= W + 1024, a multiple
    of 1024)."""
    T = arr.shape[0]
    Tp = max(W + 1024, -(-T // 1024) * 1024)
    if Tp != T:
        arr = torch.cat([arr, arr.new_zeros(Tp - T)])
    return arr


def safe_lookup(values: torch.Tensor, keys: torch.Tensor,
                W: int = DEFAULT_W, C: int = DEFAULT_C,
                max_patch: int = 64) -> torch.Tensor:
    """``values[keys]`` with miss-as-0 (keys < 0 or >= len(values)).

    One windowed lookup (K2) answers the keys and flags the chunks whose
    in-range keys its windows miss; their count comes back in one read and
    picks the route.  Route 0: every chunk covered, K2's words stand.
    Route 1: at most ``cap`` chunks uncovered; those chunks are re-resolved
    by a small gather.  Route 2: too many uncovered chunks; K2's words are
    dropped and a plain gather answers the whole stream.  K2 never reads
    outside the table, so running it before the route is known is safe.
    """
    values, keys = values.contiguous(), keys.contiguous()
    T = values.shape[0]
    n = keys.shape[0]
    pad = (-n) % C
    kp = torch.cat([keys, keys.new_full((pad,), -1)]) if pad else keys
    nchunks = kp.shape[0] // C
    out, bad, nbad = windowed_lookup_covered(_pad_table(values, W), kp, T,
                                             C=C, W=W)
    nbad = host_read(nbad, "lookup.route")
    cap = min(max(max_patch, nchunks // 64), nchunks)
    route = (ROUTE_WINDOWED if nbad == 0 else
             ROUTE_PATCHED if nbad <= cap else ROUTE_GATHER)
    _record_route(route, nbad)

    if route == ROUTE_GATHER:
        out = torch.where((kp >= 0) & (kp < T),
                          values[kp.clamp(0, T - 1).long()], 0)
    elif route == ROUTE_PATCHED:
        rows = (torch.nonzero(bad).view(-1, 1) * C
                + torch.arange(C, device=kp.device)).view(-1)
        pk = kp[rows]
        ok = (pk >= 0) & (pk < T)
        out[rows] = torch.where(ok, values[pk.clamp(0, T - 1).long()], 0)
    return out[:n] if pad else out


def stride_params(stride: float, margin: float = 1.0) -> tuple:
    """(W, C) for a key stream advancing ~``stride`` positions per element:
    C = 1024, W grows to cover ``C * stride * margin``, up to 8192."""
    C = DEFAULT_C
    need = int(C * max(stride, 1.0) * margin)
    W = DEFAULT_W
    while W < need and W < 8192:
        W *= 2
    return W, C


class SortedProbes(NamedTuple):
    skey: torch.Tensor    #: sorted keys, u32 carrier
    srow: torch.Tensor    #: original row ids, int32
    lookup_w: int         #: window width key-keyed lookups need
    segment: int | None   #: probe-sort segment (None = global sort)


def _sort_global(pk: torch.Tensor):
    s, idx = torch.sort(pk ^ SIGN, stable=True)
    return s ^ SIGN, idx.to(I32)


def packed_key_bits(chunk: int, domain: int) -> int | None:
    """The key width K1 sorts a probe stream in ``chunk`` segments over a
    key ``domain`` with, or None where K1 cannot take the stream: keys too
    wide for its row field, or a segment outside its range (the policy's
    second cap gives segments of up to 2^20 keys; only 2^18 fit K1)."""
    key_bits = max(int(domain - 1).bit_length(), 1)
    if 32 - key_bits >= 9 and 512 <= chunk <= MAX_SEGMENT_BITONIC:
        return key_bits
    return None


def _sort_probes(pk: torch.Tensor, domain: int | None = None) -> SortedProbes:
    """The strand's one sort.  With a known key ``domain`` it is segmented
    (``ops/sort.py:probe_sort_chunk``); small domains take the packed K1
    route when every key is below ``2^key_bits`` and the segment fits K1
    (:func:`packed_key_bits`), wider streams the 2-op K4 route (past 2^18
    keys a segment, the library's).  An already ascending stream is not
    sorted at all."""
    with span("hj.probe.sort"):
        P = pk.shape[0]
        rowv = torch.arange(P, dtype=I32, device=pk.device)
        chunk = probe_sort_chunk(P, domain)
        W = window_for_chunk(chunk, domain) if domain else DEFAULT_W
        if chunk is None:
            if domain:
                # global-sort sparse-stream margin (see _sort_bucket_ids)
                W = max(W, stride_params(domain / max(P, 1),
                                         margin=2.0)[0])
            if is_sorted_ascending(pk):
                return SortedProbes(pk, rowv, W, None)
            return SortedProbes(*_sort_global(pk), W, None)

        if is_sorted_ascending(pk):
            return SortedProbes(pk, rowv, W, chunk)
        key_bits = packed_key_bits(chunk, domain)
        if key_bits is not None and host_read(
                ((pk >> key_bits) == 0).all(), "sort.key_bits"):
            sk, lid = bitonic_sort_packed_segmented(pk, chunk, key_bits)
            seg_base = torch.arange(P // chunk, dtype=I32, device=pk.device)
            sr = (lid.view(-1, chunk)
                  + (seg_base * chunk)[:, None]).view(P)
            return SortedProbes(sk, sr, W, chunk)
        # duplicate probes of one key are interchangeable (identical match
        # sets), so the sort may drop its row-id tiebreak
        return SortedProbes(*sort_segmented(pk, chunk, stable=False), W,
                            chunk)


def _sort_live(pk: torch.Tensor, mask: torch.Tensor):
    """The probe sort under a selection ``mask``: dead rows travel as the
    all-ones key, which sorts last unsigned and reads as a miss on the
    int32 carrier, and their liveness rides the sort, so a live key
    0xFFFFFFFF still counts its miss walk.  Returns ``(sorted keys, live,
    original rows)``."""
    with span("hj.probe.sort"):
        pk_m = torch.where(mask, pk, -1)
        s, idx = torch.sort(pk_m ^ SIGN, stable=True)
        return s ^ SIGN, mask[idx], idx.to(I32)


def _sort_bucket_ids(b: torch.Tensor, num_buckets: int):
    """(ascending bucket-id stream, lookup W); segmented when profitable
    (the -1 dead markers sort to each segment's front)."""
    P = b.shape[0]
    chunk = probe_sort_chunk(P, num_buckets)
    W = window_for_chunk(chunk, num_buckets)
    if chunk is None:
        W = max(W, stride_params(num_buckets / max(P, 1), margin=2.0)[0])
        return torch.sort(b).values, W
    return sort_segmented_1op(b, chunk), W


def _miss_chain_cmps(table_bucket_len, num_buckets, skey, miss_mask,
                     hashfun="murmur") -> torch.Tensor:
    """Comparisons of the missing probes: each walks its whole bucket chain
    (``algebra.hh:640-658``).  Runs only when a probe misses."""
    with span("hj.probe.miss"):
        if not host_read(miss_mask.any(), "miss.any"):
            return torch.zeros((), dtype=I64, device=skey.device)
        b = bucket_of(hash_key(skey, hashfun), num_buckets)
        b = torch.where(miss_mask, b, -1)
        b_sorted, Wb = _sort_bucket_ids(b, num_buckets)
        with _suppress_routes():
            return safe_lookup(table_bucket_len, b_sorted,
                               W=Wb).to(I64).sum()


@_with_route
def direct_probe_strand_sorted(table, pk: torch.Tensor, unique: bool = False,
                               nested: bool = False, mask=None) -> dict:
    """Windowed Csr / CsrUU / Nsr / CsrSel probe strand over a dense-direct
    table.

    ``pk``: probe keys, u32 carrier on the table's device.  One windowed
    lookup of the packed ``(row | pos+1 << shift)`` word answers each
    sorted probe.  ``unique=True`` (Csr) counts the early-exit position;
    ``unique=False`` (CsrUU, a chaining table built with
    ``full_chain_index``) counts the key's whole chain, a second lookup of
    ``chain_by_key``; ``nested=True`` (Nsr, a nested dense-direct table)
    counts the main-chain position, walks ``bucket_main_len`` on a miss and
    unnests the singleton groups positionally (``c_unnest`` = matches).
    ``mask`` (CsrSel's pushed-down selection) marks the live probe rows:
    dead rows neither match nor walk a chain (:func:`_sort_live`).
    Returns the result pairs (``probe_row``, ``build_row``; -1 where a
    sorted probe missed), ``total`` / ``c_htProbe`` (matches) and
    ``c_htProbeCmp``, plus ``route_worst`` / ``route_nbad``.
    """
    direct = table.direct
    _check_device(pk, direct)
    n = direct.shape[0]
    if mask is None:
        skey, srow, Wk, _ = _sort_probes(pk, domain=n)
        live = None
    else:
        skey, live, srow = _sort_live(pk, mask)
        # the segment policy's window, though the masked sort is global
        Wk = window_for_chunk(probe_sort_chunk(pk.shape[0], n), n)
    with span("hj.probe.lookup"):
        # the int32 carrier already reads keys >= 2^31 as negative = miss
        d = safe_lookup(direct, skey, W=Wk)
        hit = d != 0  # packed words carry a 1-based chain position
        if live is not None:
            hit &= live
        shift = table.direct_shift
        row = d & ((1 << shift) - 1)
        miss = ~hit if live is None else live & ~hit

    blen = table.bucket_main_len if nested else table.bucket_len
    miss_cmps = _miss_chain_cmps(blen, table.num_buckets, skey, miss,
                                 table.hashfun)
    if not (unique or nested):
        # no early exit: every hit walks its key's whole chain
        with span("hj.probe.lookup"):
            walked = safe_lookup(table.chain_by_key, skey, W=Wk)
    with span("hj.probe.emit"):
        if unique or nested:
            walked = shr(d, shift) if shift else d
        cmps = torch.where(hit, walked, 0).to(I64).sum() + miss_cmps
        m = hit.to(I64).sum()
        out = dict(
            probe_row=torch.where(hit, srow, -1),
            build_row=torch.where(hit, row, -1),
            total=m,
            c_htProbe=m,
            c_htProbeCmp=cmps,
        )
    if nested:
        out["c_unnest"] = m
    return out


def rows_window(P: int, segment: int | None, n_rows: int,
                out_size: int) -> tuple:
    """(W, C) for CSR row-position streams (``group_start[g] + within``)
    emitted by the expansion of a ``segment``-sorted probe stream: a
    segmented stream revisits the whole ``n_rows`` range once per segment,
    multiplying the advance rate by ``P / segment``; the window keeps a 2x
    margin over the expected spread."""
    nseg = 1 if segment is None else max(P // segment, 1)
    return stride_params(nseg * n_rows / max(out_size, 1), margin=2.0)


def _keydirect_probe(table, skey: torch.Tensor, g: torch.Tensor | None = None,
                     live: torch.Tensor | None = None, W: int = DEFAULT_W):
    """Windowed ``key_direct`` probe of sorted keys: ``(g, hit, glen, pos1,
    miss_cmps)`` with -1 / 0 miss markers.  ``g`` skips the key_direct
    lookup when the caller already has the group-id stream (permutation
    and iota probes: the key_direct image itself); ``live`` keeps dead
    rows out of the miss walk.  The g stream inherits the key stream's
    order, so one window width ``W`` serves both."""
    with span("hj.probe.lookup"):
        if g is None:
            g = _key_groups(table, skey, W)
        hit = g >= 0
        glen = safe_lookup(table.groups.group_len, g, W=W)
        pos1 = safe_lookup(table.main_pos_by_group + 1, g, W=W)
        miss = ~hit if live is None else live & ~hit
    miss_cmps = _miss_chain_cmps(table.bucket_main_len, table.num_buckets,
                                 skey, miss, table.hashfun)
    return g, hit, glen, pos1, miss_cmps


def _key_groups(table, skey: torch.Tensor, W: int = DEFAULT_W):
    """Each sorted key's group through ``key_direct`` (-1 = absent)."""
    return safe_lookup(table.key_direct + 1, skey, W=W) - 1


def _iota_groups(key_direct: torch.Tensor, P: int) -> torch.Tensor:
    """The group stream of the probe keys [0, P): the key_direct image,
    padded with -1 past its domain."""
    dom = key_direct.shape[0]
    return (key_direct[:P] if P <= dom else
            torch.cat([key_direct, key_direct.new_full((P - dom,), -1)]))


def _check_device(pk: torch.Tensor, table_col: torch.Tensor) -> None:
    if pk.device != table_col.device:
        raise ValueError(f"probe keys on {pk.device}, table on "
                         f"{table_col.device}")


def _probe_order(table, pk, probes_iota, probes_permutation, mask,
                 presorted=False, srow_values=None, lookup_w=None,
                 segment=None):
    """The probe side of the key_direct strands: ``(skey, srow, g, live,
    Wk, seg)``.  ``presorted``: the caller sorted ``pk`` already,
    globally or in blocks (an exchange receive, a circulating ring
    chunk), with its dead rows (``mask`` False) on the all-ones key;
    nothing is sorted, ``srow_values`` (default: the positions) are the
    emitted probe ids, and ``lookup_w`` / ``segment`` are the window and
    sort segment the caller's sort needs.  ``probes_iota`` (keys exactly
    [0, P): exp-4's R.k) sorts nothing and emits the probe rows as they
    are (``srow`` None); ``probes_permutation`` (a permutation of [0, P):
    exp-1's R.k) needs one inverse permutation; both read the key_direct
    image as the group stream (``g``).  ``mask`` sorts globally with
    liveness riding (:func:`_sort_live`); anything else takes
    :func:`_sort_probes`."""
    with span("hj.probe.sort"):
        P = pk.shape[0]
        kd = table.key_direct
        if srow_values is not None and not presorted:
            raise ValueError("srow_values needs presorted=True")
        if (presorted or mask is not None) and (probes_iota
                                                or probes_permutation):
            raise ValueError("presorted / mask exclude probes_iota / "
                             "probes_permutation")
        W = lookup_w or DEFAULT_W
        if presorted:
            skey = pk if mask is None else torch.where(mask, pk, -1)
            srow = (torch.arange(P, dtype=I32, device=pk.device)
                    if srow_values is None else srow_values.to(I32))
            return skey, srow, None, mask, W, segment
        if mask is not None:
            skey, live, srow = _sort_live(pk, mask)
            return skey, srow, None, live, W, segment
        if probes_iota or probes_permutation:
            rowv = torch.arange(P, dtype=I32, device=pk.device)
            # sorted(permutation of [0, P)) is the identity; srow its inverse
            srow = None if probes_iota else inverse_permute(pk, rowv)
            return rowv, srow, _iota_groups(kd, P), None, DEFAULT_W, None
        skey, srow, Wk, seg = _sort_probes(pk, domain=kd.shape[0])
        return skey, srow, None, None, Wk, seg


@_with_route
def keydirect_nested_strand_sorted(table, pk: torch.Tensor, out_size: int,
                                   do_unnest: bool = True,
                                   probes_iota: bool = False,
                                   probes_permutation: bool = False,
                                   mask=None, presorted: bool = False,
                                   srow_values=None,
                                   lookup_w: int | None = None,
                                   segment: int | None = None) -> dict:
    """Windowed Nrs / NrsNU / NrsSel probe strand over a ``key_direct``
    nested table.

    The probe side comes from :func:`_probe_order`: sorted over the
    key_direct domain, not sorted at all for an iota or a permutation
    probe column, or sorted with its liveness under a ``mask`` (NrsSel).
    Every per-group array is then read by ``safe_lookup`` (K2) on a
    nondecreasing stream.  ``do_unnest`` expands each hit into its group's
    rows (``expand``; build rows ascending within a group, probe rows from
    ``srow[p]``), up to ``out_size`` result pairs, ``c_unnest`` = the
    expanded count; without it the nested tuples (``nested_g``,
    ``nested_hit``, ``nested_probe_row``) go to the top, ``c_top`` =
    matches and ``c_expand_total`` is the hits' group-length sum, the
    exact unnested size ``api.join`` sizes its buffer from.
    ``presorted`` (an exchange receive or a ring chunk, sorted globally
    or in blocks, dead rows on the all-ones key under ``mask``) skips the
    sort: ``srow_values`` are then the emitted probe ids (a shard's
    global rows), ``lookup_w`` the window its block spread needs and
    ``segment`` the caller's sort segment, which widens the emission's
    row window as a local segmented sort would (:func:`_probe_order`).
    """
    _check_device(pk, table.key_direct)
    P = pk.shape[0]
    skey, srow, g0, live, Wk, seg = _probe_order(
        table, pk, probes_iota, probes_permutation, mask, presorted,
        srow_values, lookup_w, segment)
    g, hit, glen, pos1, miss_cmps = _keydirect_probe(table, skey, g=g0,
                                                     live=live, W=Wk)
    with span("hj.probe.emit"):
        m = hit.to(I64).sum()
        cmps = pos1.to(I64).sum() + miss_cmps
        if not do_unnest:
            prow = skey if srow is None else srow  # iota: the rows
            return dict(nested_g=torch.where(hit, g, -1), nested_hit=hit,
                        nested_probe_row=prow, c_htProbe=m,
                        c_htProbeCmp=cmps, c_top=m,
                        c_expand_total=glen.to(I64).sum())

    with span("hj.probe.lookup"):
        gstart_by_p = safe_lookup(table.groups.group_start, g, W=Wk)
    with span("hj.probe.unnest"):
        p, within, valid, total = expand(glen, out_size)[:4]
        # p-keyed lookups advance by ~P/out_size per output slot
        Wp, Cp = stride_params(P / out_size)
        gst = safe_lookup(gstart_by_p, p, W=Wp, C=Cp)
        # ascending within-group emission keeps group_rows positions
        # near-contiguous, so the windowed lookup covers even a
        # million-row group; pairs are multiset-equal to the reference's
        # [first, rest LIFO]
        Wr, Cr = rows_window(P, seg, table.groups.group_rows.shape[0],
                             out_size)
        build_row = safe_lookup(table.groups.group_rows, gst + within,
                                W=Wr, C=Cr)
        probe_row = p if srow is None else safe_lookup(srow, p, W=Wp, C=Cp)
    with span("hj.probe.emit"):
        total = total.to(I64)
        return dict(
            probe_row=torch.where(valid, probe_row, -1),
            build_row=torch.where(valid, build_row, -1),
            total=total,
            c_htProbe=m, c_htProbeCmp=cmps,
            c_unnest=total,
        )


def _full_chain_cmps(table, skey: torch.Tensor, live=None) -> torch.Tensor:
    """Comparisons of probes that walk their whole bucket chain (no early
    exit): the bucket-length sum over the live probes' sorted bucket-id
    stream (hash-ordered, so it gets its own sort)."""
    with span("hj.probe.miss"):
        b = bucket_of(hash_key(skey, table.hashfun), table.num_buckets)
        if live is not None:
            b = torch.where(live, b, -1)
        b_sorted, Wb = _sort_bucket_ids(b, table.num_buckets)
        return safe_lookup(table.bucket_len, b_sorted, W=Wb).to(I64).sum()


@_with_route
def keydirect_chaining_strand_sorted(table, pk: torch.Tensor, out_size: int,
                                     unique: bool = False, mask=None,
                                     presorted: bool = False,
                                     probes_permutation: bool = False,
                                     srow_values=None,
                                     lookup_w: int | None = None) -> dict:
    """Windowed Crs / CrsSel probe strand over a ``key_direct`` chaining
    table (``algebra.hh:625-659``).

    The probe side comes from :func:`_probe_order`: permutation probes
    (Crs, exp-1's R.k) are not sorted, masked probes (CrsSel) sort with
    their liveness, any other column takes :func:`_sort_probes` (K1 where
    its keys fit the packed route).  ``unique=False``: every live probe
    walks its whole bucket chain (:func:`_full_chain_cmps`) and emits its
    whole key group.  ``unique=True`` (IsBuildKeyUnique): comparisons stop
    at the key's first node in chain order (``group_min_pos``), a miss
    walks its chain, and each hit emits ``group_chain_first``; the table
    needs the early-exit index.  Emission rides ``expand`` (K3) and the
    windowed lookups, as in the nested strand.  ``presorted``,
    ``srow_values`` and ``lookup_w``: a (block-)sorted stream with its
    dead rows on the all-ones key, as in the nested strand.
    """
    _check_device(pk, table.key_direct)
    P = pk.shape[0]
    skey, srow, g, live, Wk, seg = _probe_order(
        table, pk, False, probes_permutation, mask, presorted, srow_values,
        lookup_w)
    if unique and table.group_min_pos.shape[0] == 0:
        raise ValueError(
            "table was built with early_exit_index=False; "
            "IsBuildKeyUnique probes need the chain-position index")
    with span("hj.probe.lookup"):
        if g is None:
            g = _key_groups(table, skey, Wk)
        hit = g >= 0
        glen = safe_lookup(table.groups.group_len, g, W=Wk)
        if unique:
            pos1 = safe_lookup(table.group_min_pos + 1, g, W=Wk)
            # emission source: the first matching row in chain order
            row_by_p = safe_lookup(table.group_chain_first + 1, g, W=Wk) - 1
            miss = ~hit if live is None else live & ~hit
        else:
            gstart_by_p = safe_lookup(table.groups.group_start, g, W=Wk)
    if unique:
        miss_cmps = _miss_chain_cmps(table.bucket_len, table.num_buckets,
                                     skey, miss, table.hashfun)
    else:
        miss_cmps = _full_chain_cmps(table, skey, live)
    with span("hj.probe.emit"):
        counts = hit.to(I32) if unique else glen
        m = counts.to(I64).sum()
        cmps = pos1.to(I64).sum() + miss_cmps if unique else miss_cmps

    with span("hj.probe.unnest"):
        p, within, valid, total = expand(counts, out_size)[:4]
        Wp, Cp = stride_params(P / out_size)
        if unique:
            build_row = safe_lookup(row_by_p, p, W=Wp, C=Cp)
        else:
            gst = safe_lookup(gstart_by_p, p, W=Wp, C=Cp)
            Wr, Cr = rows_window(P, seg, table.groups.group_rows.shape[0],
                                 out_size)
            build_row = safe_lookup(table.groups.group_rows, gst + within,
                                    W=Wr, C=Cr)
        probe_row = safe_lookup(srow, p, W=Wp, C=Cp)
    with span("hj.probe.emit"):
        return dict(
            probe_row=torch.where(valid, probe_row, -1),
            build_row=torch.where(valid, build_row, -1),
            total=total.to(I64),
            c_htProbe=m, c_htProbeCmp=cmps,
        )


def _merge_groups(ukey: torch.Tensor, pk: torch.Tensor):
    """Sort-merge group resolution that stays in merged (sorted) order, for
    keys with no dense ``key_direct`` index (u64, composite, sparse u32).

    One stable sort of ``[ukey; pk]`` in unsigned order (the library sort,
    as the JAX package's is ``lax.sort``): stability puts each directory
    entry before its equal probe keys.  Each equal-key run's start comes
    from K3's ``("max",)`` scan, and the run head's source index, fetched
    by ``safe_lookup`` (K2; ``run_start`` advances at most one a slot, so
    every window covers it), is the group id.  Returns merged-order
    ``(skey, g, is_probe, probe_row_by_pos)`` of length ``K + P``; ``g`` is
    -1 where the run head is a probe (the key is not in the directory);
    padding slots surface with their own ``g`` and are rejected by the
    caller's ``group_len > 0`` gate."""
    from .scan import multi_scan

    same_key_width(ukey, pk)
    K = ukey.shape[0]
    M = K + pk.shape[0]
    s, idx = torch.sort(uorder(torch.cat([ukey, pk])), stable=True)
    skey = uorder(s)
    idx_s = idx.to(I32)
    i = torch.arange(M, dtype=I32, device=pk.device)
    is_first = torch.ones(M, dtype=torch.bool, device=pk.device)
    is_first[1:] = skey[1:] != skey[:-1]
    (run_start,) = multi_scan((torch.where(is_first, i, -1),), ("max",))
    head = safe_lookup(idx_s, run_start)
    g = torch.where(head < K, head, -1)
    return skey, g, idx_s >= K, idx_s - K


@_with_route
def merged_nested_strand_sorted(table, pk: torch.Tensor, out_size: int,
                                do_unnest: bool = True) -> dict:
    """Windowed nested probe strand for u64, composite and sparse-domain
    keys: :func:`keydirect_nested_strand_sorted` with its group ids from
    :func:`_merge_groups` instead of a ``key_direct`` index.  Counters equal
    ``probe_nested`` + ``unnest`` (``ht_nested.hh:354-382``); emission is
    ascending insertion order per group (multiset-equal pairs).
    ``do_unnest=False`` returns the counters and ``c_expand_total`` (the
    exact unnested size) without materialising: ``api.join``'s sizing
    pass.  ``pk`` rides the table's key carrier."""
    _check_device(pk, table.groups.ukey)
    ukey = table.groups.ukey
    M = ukey.shape[0] + pk.shape[0]
    with span("hj.probe.sort"):
        skey, g, is_probe, prow_by_pos = _merge_groups(ukey, pk)
    with span("hj.probe.lookup"):
        glen = safe_lookup(table.groups.group_len, g)
        hit = is_probe & (g >= 0) & (glen > 0)
        pos1 = safe_lookup(table.main_pos_by_group + 1, g)
        miss = is_probe & ~hit
    miss_cmps = _miss_chain_cmps(table.bucket_main_len, table.num_buckets,
                                 skey, miss, table.hashfun)
    with span("hj.probe.emit"):
        m = hit.to(I64).sum()
        # padding slots have no main position: gate by hit
        cmps = torch.where(hit, pos1, 0).to(I64).sum() + miss_cmps
        counts = torch.where(hit, glen, 0)
        if not do_unnest:
            return dict(c_htProbe=m, c_htProbeCmp=cmps,
                        c_expand_total=counts.to(I64).sum())

    with span("hj.probe.lookup"):
        gstart_by_pos = safe_lookup(table.groups.group_start, g)
    with span("hj.probe.unnest"):
        p, within, valid, total = expand(counts, out_size)[:4]
        Wp, Cp = stride_params(M / out_size)
        gst = safe_lookup(gstart_by_pos, p, W=Wp, C=Cp)
        build_row = safe_lookup(table.groups.group_rows, gst + within)
        probe_row = safe_lookup(torch.clamp(prow_by_pos, min=0), p, W=Wp,
                                C=Cp)
    with span("hj.probe.emit"):
        total = total.to(I64)
        return dict(
            probe_row=torch.where(valid, probe_row, -1),
            build_row=torch.where(valid, build_row, -1),
            total=total,
            c_htProbe=m, c_htProbeCmp=cmps,
            c_unnest=total,
        )


@_with_route
def merged_chaining_strand_sorted(table, pk: torch.Tensor, out_size: int,
                                  unique: bool = False,
                                  do_expand: bool = True) -> dict:
    """Windowed chaining probe strand for u64, composite and sparse-domain
    keys (``algebra.hh:625-659``): :func:`keydirect_chaining_strand_sorted`
    with its group ids from :func:`_merge_groups`.  Without ``unique`` the
    whole-chain counts sum ``bucket_len`` over the probes' sorted bucket
    ids (:func:`_full_chain_cmps`: K4 where the segment policy picks it).
    Those ids come from the P probe keys, not from the merged stream: the
    JAX package hashes all K + P merged keys with the directory's marked
    dead, which halves the live density of Crs-shaped streams (K = P) and
    leaves the window no margin (most chunks uncovered, route 2, on the
    card); the sum is the same.
    ``do_expand=False`` returns the counters only (the emitted-pair total
    of a chaining probe is ``c_htProbe``).  ``pk`` rides the table's key
    carrier."""
    _check_device(pk, table.groups.ukey)
    ukey = table.groups.ukey
    M = ukey.shape[0] + pk.shape[0]
    if unique and table.group_min_pos.shape[0] == 0:
        raise ValueError(
            "table was built with early_exit_index=False; "
            "IsBuildKeyUnique probes need the chain-position index")
    with span("hj.probe.sort"):
        skey, g, is_probe, prow_by_pos = _merge_groups(ukey, pk)
    with span("hj.probe.lookup"):
        glen = safe_lookup(table.groups.group_len, g)
        hit = is_probe & (g >= 0) & (glen > 0)
        if unique:
            pos1 = safe_lookup(table.group_min_pos + 1, g)
            row_by_pos = safe_lookup(table.group_chain_first + 1, g) - 1
            miss = is_probe & ~hit
    if unique:
        miss_cmps = _miss_chain_cmps(table.bucket_len, table.num_buckets,
                                     skey, miss, table.hashfun)
    else:
        miss_cmps = _full_chain_cmps(table, pk)
    with span("hj.probe.emit"):
        if unique:
            counts = hit.to(I32)
            m = hit.to(I64).sum()
            cmps = torch.where(hit, pos1, 0).to(I64).sum() + miss_cmps
        else:
            counts = torch.where(hit, glen, 0)
            m = counts.to(I64).sum()
            cmps = miss_cmps
        if not do_expand:
            return dict(c_htProbe=m, c_htProbeCmp=cmps)

    with span("hj.probe.unnest"):
        p, within, valid, total = expand(counts, out_size)[:4]
        Wp, Cp = stride_params(M / out_size)
        if unique:
            build_row = safe_lookup(row_by_pos, p, W=Wp, C=Cp)
        else:
            gstart_by_pos = safe_lookup(table.groups.group_start, g)
            gst = safe_lookup(gstart_by_pos, p, W=Wp, C=Cp)
            build_row = safe_lookup(table.groups.group_rows, gst + within)
        probe_row = safe_lookup(torch.clamp(prow_by_pos, min=0), p, W=Wp,
                                C=Cp)
    with span("hj.probe.emit"):
        return dict(
            probe_row=torch.where(valid, probe_row, -1),
            build_row=torch.where(valid, build_row, -1),
            total=total.to(I64),
            c_htProbe=m, c_htProbeCmp=cmps,
        )


def _second_probe(tbl_t, sk: torch.Tensor, hit_s: torch.Tensor):
    """exp-4's T probe of the iota keys, run only under the S hit mask
    (``algebra.hh:451-458``): ``(g_t, both, glen_t, pos1_t, miss_t)``;
    T misses count only where S hit."""
    with span("hj.probe.lookup"):
        g_t = torch.where(hit_s, _key_groups(tbl_t, sk), -1)
        both = g_t >= 0
        glen_t = safe_lookup(tbl_t.groups.group_len, g_t)
        pos1_t = safe_lookup(tbl_t.main_pos_by_group + 1, g_t)
        miss = hit_s & ~both
    miss_t = _miss_chain_cmps(tbl_t.bucket_main_len, tbl_t.num_buckets, sk,
                              miss, tbl_t.hashfun)
    return g_t, both, glen_t, pos1_t, miss_t


@_with_route
def ndu_strand_sorted(tbl_s, tbl_t, keys_iota: torch.Tensor, out1: int,
                      out2: int) -> dict:
    """Windowed exp-4 Ndu probe strand (``main_experiment4.cc:832-941``):
    scan R -> NestProbe(S) -> NestProbe(T) -> Unnest(T) -> Unnest(S).

    R.k is an iota, so nothing is sorted; both probes read the key_direct
    images, the T probe only under the S hits, and both unnests ride
    ``expand`` (K3) and windowed lookups: ``out1`` slots for the T
    duplicates of the rows that hit both, ``out2`` for the result triples.
    Returns the triples (``r_row``, ``s_row``, ``t_row``; -1 past the
    result), ``valid`` and the counters c_probe_RS(_cmp), c_probe_RT(_cmp),
    c_unnest_1 (T) and c_unnest_2 (S, the result).
    """
    _check_device(keys_iota, tbl_s.key_direct)
    sk = keys_iota
    P = sk.shape[0]
    g_s, hit_s, glen_s, pos1_s, miss_s = _keydirect_probe(tbl_s, sk)
    with span("hj.probe.emit"):
        c_rs = hit_s.to(I64).sum()
        c_rs_cmp = pos1_s.to(I64).sum() + miss_s
    g_t, both, glen_t, pos1_t, miss_t = _second_probe(tbl_t, sk, hit_s)
    with span("hj.probe.emit"):
        c_rt = both.to(I64).sum()
        c_rt_cmp = pos1_t.to(I64).sum() + miss_t

    W1, C1 = stride_params(P / out1)       # p1 advances ~P/out1 a slot
    W2, C2 = stride_params(out1 / out2)    # p2 advances ~out1/out2 a slot
    with span("hj.probe.unnest"):
        # unnest #1 (T): one slot per T duplicate of the rows that hit both
        t_counts = torch.where(both, glen_t, 0)
        gstart_t_by_p = safe_lookup(tbl_t.groups.group_start, g_t)
        p1, w1, v1, n_un1 = expand(t_counts, out1)[:4]
        gst_t = safe_lookup(gstart_t_by_p, p1, W=W1, C=C1)
        t_row = safe_lookup(tbl_t.groups.group_rows, gst_t + w1)

    with span("hj.probe.unnest"):
        # unnest #2 (S): each (r, t_row) by its S group
        glen_s_m = torch.where(both, glen_s, 0)
        s_counts = torch.where(v1, safe_lookup(glen_s_m, p1, W=W1, C=C1), 0)
        gstart_s_by_p = safe_lookup(tbl_s.groups.group_start, g_s)
        gst_s_by_p1 = safe_lookup(gstart_s_by_p, p1, W=W1, C=C1)
        p2, w2, v2, n_un2 = expand(s_counts, out2)[:4]
        gst_s = safe_lookup(gst_s_by_p1, p2, W=W2, C=C2)
        s_row = safe_lookup(tbl_s.groups.group_rows, gst_s + w2)
        t_prop = safe_lookup(t_row, p2, W=W2, C=C2)
        r_prop = safe_lookup(p1, p2, W=W2, C=C2)  # p1 IS the R row
    with span("hj.probe.emit"):
        return dict(
            r_row=torch.where(v2, r_prop, -1),
            s_row=torch.where(v2, s_row, -1),
            t_row=torch.where(v2, t_prop, -1),
            valid=v2,
            c_probe_RS=c_rs, c_probe_RS_cmp=c_rs_cmp,
            c_probe_RT=c_rt, c_probe_RT_cmp=c_rt_cmp,
            c_unnest_1=n_un1.to(I64), c_unnest_2=n_un2.to(I64),
        )


@_with_route
def chj_strand_sorted(tbl_s, tbl_t, keys_iota: torch.Tensor, out1: int,
                      out2: int) -> dict:
    """Windowed exp-4 Chj probe strand (``main_experiment4.cc:943-1043``):
    Probe(S) materialises every RS pair, then each pair probes T with its
    R key, both probes walking whole chains (no early exit).

    The S chain walks sum ``bucket_len`` over the sorted bucket-id stream
    (K4); the T walks read each key's chain length from a plain index over
    the whole key domain (the iota keys' buckets are hash-ordered, so no
    window could cover them), then a windowed lookup by the pair's R row.
    Returns the triples and c_probe_RS(_cmp), c_probe_RT(_cmp), c_top.
    """
    _check_device(keys_iota, tbl_s.key_direct)
    sk = keys_iota
    P = sk.shape[0]
    with span("hj.probe.lookup"):
        g_s = _key_groups(tbl_s, sk)
        glen_s = safe_lookup(tbl_s.groups.group_len, g_s)
        c_rs = glen_s.to(I64).sum()
    c_rs_cmp = _full_chain_cmps(tbl_s, sk)

    W1, C1 = stride_params(P / out1)
    W2, C2 = stride_params(out1 / out2)
    with span("hj.probe.unnest"):
        # expansion #1: the RS pairs
        gstart_s_by_p = safe_lookup(tbl_s.groups.group_start, g_s)
        p1, w1, v1, _ = expand(glen_s, out1)[:4]
        gst_s = safe_lookup(gstart_s_by_p, p1, W=W1, C=C1)
        s_row = safe_lookup(tbl_s.groups.group_rows, gst_s + w1)

    with span("hj.probe.lookup"):
        # each pair probes T with its R key, which is p1 (an iota)
        g_t_by_p = _key_groups(tbl_t, sk)
        glen_t_by_p = safe_lookup(tbl_t.groups.group_len, g_t_by_p)
        t_counts = torch.where(v1, safe_lookup(glen_t_by_p, p1, W=W1, C=C1),
                               0)
        c_rt = t_counts.to(I64).sum()
    with span("hj.probe.miss"):
        dom = torch.arange(tbl_t.key_direct.shape[0], dtype=I32,
                           device=sk.device)
        chain_t = tbl_t.bucket_len[
            bucket_of(hash_key(dom, tbl_t.hashfun),
                      tbl_t.num_buckets).long()]
        cmps_t_by_key = safe_lookup(chain_t, sk)
        c_rt_cmp = torch.where(v1, safe_lookup(cmps_t_by_key, p1, W=W1,
                                               C=C1), 0).to(I64).sum()

    with span("hj.probe.unnest"):
        # expansion #2: one slot per T duplicate of each pair
        gstart_t_by_p = safe_lookup(tbl_t.groups.group_start, g_t_by_p)
        gst_t_by_p1 = safe_lookup(gstart_t_by_p, p1, W=W1, C=C1)
        p2, w2, v2, n_rst = expand(t_counts, out2)[:4]
        gst_t = safe_lookup(gst_t_by_p1, p2, W=W2, C=C2)
        t_row = safe_lookup(tbl_t.groups.group_rows, gst_t + w2)
        s_prop = safe_lookup(s_row, p2, W=W2, C=C2)
        r_prop = safe_lookup(p1, p2, W=W2, C=C2)
    with span("hj.probe.emit"):
        return dict(
            r_row=torch.where(v2, r_prop, -1),
            s_row=torch.where(v2, s_prop, -1),
            t_row=torch.where(v2, t_row, -1),
            c_probe_RS=c_rs, c_probe_RS_cmp=c_rs_cmp,
            c_probe_RT=c_rt, c_probe_RT_cmp=c_rt_cmp,
            c_top=n_rst.to(I64),
        )


@_with_route
def nnu_strand_sorted(tbl_s, tbl_t, keys_iota: torch.Tensor) -> dict:
    """Windowed exp-4 Nnu probe strand: the two nested probes of Ndu, no
    unnesting; the nested tuples (``g_s``, ``g_t``; -1 unless both hit)
    go to the top, ``c_top`` = rows that hit both."""
    _check_device(keys_iota, tbl_s.key_direct)
    sk = keys_iota
    g_s, hit_s, _, pos1_s, miss_s = _keydirect_probe(tbl_s, sk)
    g_t, both, _, pos1_t, miss_t = _second_probe(tbl_t, sk, hit_s)
    with span("hj.probe.emit"):
        c_rt = both.to(I64).sum()
        return dict(
            g_s=torch.where(both, g_s, -1),
            g_t=torch.where(both, g_t, -1),
            c_probe_RS=hit_s.to(I64).sum(),
            c_probe_RS_cmp=pos1_s.to(I64).sum() + miss_s,
            c_probe_RT=c_rt,
            c_probe_RT_cmp=pos1_t.to(I64).sum() + miss_t,
            c_top=c_rt,
        )
