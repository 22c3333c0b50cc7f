"""The sorted windowed probe strand of exp-1 plan Csr.

Port of ``hashjoin3d_tpu/ops/strands_windowed.py`` for dense-direct
chaining tables: probes are sorted once (segmented, K1 / K4), every sorted
probe fetches its packed ``direct`` word with one windowed lookup (K2), and
missing probes walk their bucket chains through a second sorted stream.
Emission is in sorted-key order; result pairs equal the reference's as
multisets and the counters (c_htProbe, c_htProbeCmp) are bit-equal.

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
from .layout import I32, I64, SIGN, is_sorted_ascending, shr
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
    """Windowed Csr probe strand over a dense-direct chaining table.

    ``pk``: probe keys, u32 carrier on the table's device.  Returns the
    result pairs (``probe_row``, ``build_row``; -1 where a sorted probe
    missed), ``total`` / ``c_htProbe`` (matches) and ``c_htProbeCmp``, plus
    ``route_worst`` / ``route_nbad``.  Only ``unique=True`` (early exit) is
    ported; ``unique=False`` (CsrUU), ``nested=True`` (Nsr) and ``mask``
    (CsrSel) come with ROADMAP slice 2.
    """
    if not unique or nested or mask is not None:
        raise NotImplementedError(
            "direct_probe_strand_sorted: only unique=True without nested or "
            "mask is ported (ROADMAP slice 2 brings CsrUU, Nsr and CsrSel)")
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
    pos1 = shr(d, shift) if shift else d

    miss_cmps = _miss_chain_cmps(table.bucket_len, table.num_buckets, skey,
                                 ~hit, table.hashfun)
    cmps = torch.where(hit, pos1, 0).to(I64).sum() + miss_cmps
    m = hit.to(I64).sum()
    return dict(
        probe_row=torch.where(hit, srow, -1),
        build_row=torch.where(hit, row, -1),
        total=m,
        c_htProbe=m,
        c_htProbeCmp=cmps,
    )

