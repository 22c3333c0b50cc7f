"""The sorted windowed probe strands of exp-1's device plans.

Port of ``hashjoin3d_tpu/ops/strands_windowed.py``: the dense-direct strand
of plans Csr, CsrUU and Nsr, and the key_direct nested strand of plans Nrs
and NrsNU.  Probes are sorted once (segmented, K1 / K4) or, for a
permutation probe column, not at all; every per-key and per-group array is
then read by one windowed lookup (K2) on a nondecreasing stream, the unnest
expansion scans with K3, and missing probes walk their bucket chains
through a second sorted stream.  Emission is in sorted-key order; result
pairs equal the reference's as multisets and the counters (c_htProbe,
c_htProbeCmp, c_unnest, c_top) are bit-equal.

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

from .bitonic import bitonic_sort_packed_segmented
from .hashing import bucket_of, hash_key
from .layout import (I32, I64, SIGN, expand, inverse_permute,
                     is_sorted_ascending, shr)
from .sort import (probe_sort_chunk, sort_segmented, sort_segmented_1op,
                   window_for_chunk)
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
    safe_lookups) to a strand's output dict."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        _route_records.append([])
        try:
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
    nbad = int(nbad)
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


def _sort_probes(pk: torch.Tensor, domain: int | None = None) -> SortedProbes:
    """The strand's one sort.  With a known key ``domain`` it is segmented
    (``ops/sort.py:probe_sort_chunk``); small domains take the packed K1
    route when every key is below ``2^key_bits``, wider streams the 2-op K4
    route.  An already ascending stream is not sorted at all."""
    P = pk.shape[0]
    rowv = torch.arange(P, dtype=I32, device=pk.device)
    chunk = probe_sort_chunk(P, domain)
    W = window_for_chunk(chunk, domain) if domain else DEFAULT_W
    if chunk is None:
        if domain:
            # global-sort sparse-stream margin (see _sort_bucket_ids)
            W = max(W, stride_params(domain / max(P, 1), margin=2.0)[0])
        if is_sorted_ascending(pk):
            return SortedProbes(pk, rowv, W, None)
        return SortedProbes(*_sort_global(pk), W, None)

    if is_sorted_ascending(pk):
        return SortedProbes(pk, rowv, W, chunk)
    key_bits = max(int(domain - 1).bit_length(), 1)
    if 32 - key_bits >= 9 and chunk >= 512 and bool(((pk >> key_bits) == 0)
                                                    .all()):
        sk, lid = bitonic_sort_packed_segmented(pk, chunk, key_bits)
        seg_base = torch.arange(P // chunk, dtype=I32, device=pk.device)
        sr = (lid.view(-1, chunk) + (seg_base * chunk)[:, None]).view(P)
        return SortedProbes(sk, sr, W, chunk)
    # duplicate probes of one key are interchangeable (identical match
    # sets), so the sort may drop its row-id tiebreak
    return SortedProbes(*sort_segmented(pk, chunk, stable=False), W, chunk)


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
    if not bool(miss_mask.any()):
        return torch.zeros((), dtype=I64, device=skey.device)
    b = bucket_of(hash_key(skey, hashfun), num_buckets)
    b = torch.where(miss_mask, b, -1)
    b_sorted, Wb = _sort_bucket_ids(b, num_buckets)
    with _suppress_routes():
        return safe_lookup(table_bucket_len, b_sorted, W=Wb).to(I64).sum()


@_with_route
def direct_probe_strand_sorted(table, pk: torch.Tensor, unique: bool = False,
                               nested: bool = False, mask=None) -> dict:
    """Windowed Csr / CsrUU / Nsr probe strand over a dense-direct table.

    ``pk``: probe keys, u32 carrier on the table's device.  One windowed
    lookup of the packed ``(row | pos+1 << shift)`` word answers each
    sorted probe.  ``unique=True`` (Csr) counts the early-exit position;
    ``unique=False`` (CsrUU, a chaining table built with
    ``full_chain_index``) counts the key's whole chain, a second lookup of
    ``chain_by_key``; ``nested=True`` (Nsr, a nested dense-direct table)
    counts the main-chain position, walks ``bucket_main_len`` on a miss and
    unnests the singleton groups positionally (``c_unnest`` = matches).
    Returns the result pairs (``probe_row``, ``build_row``; -1 where a
    sorted probe missed), ``total`` / ``c_htProbe`` (matches) and
    ``c_htProbeCmp``, plus ``route_worst`` / ``route_nbad``.  ``mask``
    (CsrSel) comes with the mask path of ROADMAP slice 3.
    """
    if mask is not None:
        raise NotImplementedError(
            "direct_probe_strand_sorted: mask (plan CsrSel) comes with the "
            "mask path of ROADMAP slice 3")
    direct = table.direct
    if pk.device != direct.device:
        raise ValueError(f"probe keys on {pk.device}, table on "
                         f"{direct.device}")
    n = direct.shape[0]
    skey, srow, Wk, _ = _sort_probes(pk, domain=n)
    # the int32 carrier already reads keys >= 2^31 as negative = miss
    d = safe_lookup(direct, skey, W=Wk)
    hit = d != 0  # packed words carry a 1-based chain position: never 0
    shift = table.direct_shift
    row = d & ((1 << shift) - 1)

    blen = table.bucket_main_len if nested else table.bucket_len
    miss_cmps = _miss_chain_cmps(blen, table.num_buckets, skey, ~hit,
                                 table.hashfun)
    if unique or nested:
        walked = shr(d, shift) if shift else d
    else:
        # no early exit: every hit walks its key's whole chain
        walked = safe_lookup(table.chain_by_key, skey, W=Wk)
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
                     W: int = DEFAULT_W):
    """Windowed ``key_direct`` probe of sorted keys: ``(g, hit, glen, pos1,
    miss_cmps)`` with -1 / 0 miss markers.  ``g`` skips the key_direct
    lookup when the caller already has the group-id stream (permutation
    probes: the key_direct image itself).  The g stream inherits the key
    stream's order, so one window width ``W`` serves both."""
    if g is None:
        g = safe_lookup(table.key_direct + 1, skey, W=W) - 1
    hit = g >= 0
    glen = safe_lookup(table.groups.group_len, g, W=W)
    pos1 = safe_lookup(table.main_pos_by_group + 1, g, W=W)
    miss_cmps = _miss_chain_cmps(table.bucket_main_len, table.num_buckets,
                                 skey, ~hit, table.hashfun)
    return g, hit, glen, pos1, miss_cmps


@_with_route
def keydirect_nested_strand_sorted(table, pk: torch.Tensor, out_size: int,
                                   do_unnest: bool = True,
                                   probes_iota: bool = False,
                                   probes_permutation: bool = False,
                                   mask=None, presorted: bool = False,
                                   srow_values=None, segment=None) -> dict:
    """Windowed Nrs / NrsNU probe strand over a ``key_direct`` nested
    table.

    The probes are sorted (``_sort_probes`` over the key_direct domain), or,
    with ``probes_permutation`` (keys a permutation of [0, P): exp-1's R.k),
    not sorted at all: the sorted keys are the identity, the probe rows one
    inverse permutation, and the key_direct image itself is the group-id
    stream.  Every per-group array is then read by ``safe_lookup`` (K2) on
    a nondecreasing stream.  ``do_unnest`` expands each hit into its
    group's rows (``expand``; build rows ascending within a group, probe
    rows from ``srow[p]``), up to ``out_size`` result pairs, ``c_unnest`` =
    the expanded count; without it the nested tuples (``nested_g``,
    ``nested_hit``, ``nested_probe_row``) go to the top and ``c_top`` =
    matches.  ``probes_iota`` (exp-4, ROADMAP slice 4), ``mask`` (slice 3)
    and ``presorted`` / ``srow_values`` / ``segment`` (slice 6) are not
    ported yet.
    """
    if probes_iota:
        raise NotImplementedError(
            "keydirect_nested_strand_sorted: probes_iota (exp-4) comes with "
            "ROADMAP slice 4")
    if mask is not None:
        raise NotImplementedError(
            "keydirect_nested_strand_sorted: mask (plan NrsSel) comes with "
            "the mask path of ROADMAP slice 3")
    if presorted or srow_values is not None or segment is not None:
        raise NotImplementedError(
            "keydirect_nested_strand_sorted: presorted / srow_values / "
            "segment (the distributed strands) come with ROADMAP slice 6")
    kd = table.key_direct
    if pk.device != kd.device:
        raise ValueError(f"probe keys on {pk.device}, table on {kd.device}")
    P = pk.shape[0]
    dom = kd.shape[0]
    if probes_permutation:
        # sorted(permutation of [0, P)) is the identity; srow its inverse
        rowv = torch.arange(P, dtype=I32, device=pk.device)
        skey, srow, Wk, seg = rowv, inverse_permute(pk, rowv), DEFAULT_W, None
        g0 = (kd[:P] if P <= dom else
              torch.cat([kd, kd.new_full((P - dom,), -1)]))
        g, hit, glen, pos1, miss_cmps = _keydirect_probe(table, skey, g=g0)
    else:
        skey, srow, Wk, seg = _sort_probes(pk, domain=dom)
        g, hit, glen, pos1, miss_cmps = _keydirect_probe(table, skey, W=Wk)
    m = hit.to(I64).sum()
    cmps = pos1.to(I64).sum() + miss_cmps

    if not do_unnest:
        return dict(nested_g=torch.where(hit, g, -1), nested_hit=hit,
                    nested_probe_row=srow, c_htProbe=m, c_htProbeCmp=cmps,
                    c_top=m)

    gstart_by_p = safe_lookup(table.groups.group_start, g, W=Wk)
    p, within, valid, total = expand(glen, out_size)[:4]
    # p-keyed lookups advance by ~P/out_size per output slot
    Wp, Cp = stride_params(P / out_size)
    gst = safe_lookup(gstart_by_p, p, W=Wp, C=Cp)
    # ascending within-group emission keeps group_rows positions
    # near-contiguous, so the windowed lookup covers even a million-row
    # group; pairs are multiset-equal to the reference's [first, rest LIFO]
    Wr, Cr = rows_window(P, seg, table.groups.group_rows.shape[0], out_size)
    build_row = safe_lookup(table.groups.group_rows, gst + within, W=Wr,
                            C=Cr)
    probe_row = safe_lookup(srow, p, W=Wp, C=Cp)
    total = total.to(I64)
    return dict(
        probe_row=torch.where(valid, probe_row, -1),
        build_row=torch.where(valid, build_row, -1),
        total=total,
        c_htProbe=m, c_htProbeCmp=cmps,
        c_unnest=total,
    )
