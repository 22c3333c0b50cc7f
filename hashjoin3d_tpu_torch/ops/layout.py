"""Integer carriers, the run-structure primitives, the CSR group layout
and the directory lookups.

Port of ``hashjoin3d_tpu/ops/layout.py`` (the parts the builds, the unnest
expansion and the probe ops use, the clarity builds' ``key_group_index``
and ``emit_pos`` among them).  PyTorch's ``uint32`` and ``uint64`` have
no add, shifts, ``<``, ``%``, cummax or scatter, so every u32 column rides
as the int32 tensor with the same bits, and every u64 column (a 64-bit or a
composite :func:`pack2u32` key) as the int64 tensor with the same bits:

* add and multiply wrap exactly as the unsigned type;
* an unsigned compare or sort flips the sign bit first (:func:`uorder`:
  ``x ^ SIGN`` on int32, ``x ^ SIGN64`` on int64);
* a logical right shift is :func:`shr` (``hashing.shr64`` on int64);
* 32-bit arithmetic that must see the unsigned value widens to int64 with
  :func:`u32_to_i64` and comes back through :func:`i64_to_u32`; a u32
  column that meets a u64 one zero-extends the same way, so the padding
  key 0xFFFFFFFF stays 2^32 - 1.

Counters are int64.

Where the JAX package compacts run heads or places expansion heads with a
sort on the TPU, the port takes the scatter.  The scatters of
:func:`compact_group_index`, :func:`key_direct_index` and :func:`expand`
send the entries they drop to slots of their own past the kept range, not
all to one slot, so no two stores meet at one address.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..utils.tracing import host_read

I32 = torch.int32
I64 = torch.int64
#: int32 sign bit: ``x ^ SIGN`` maps u32 order onto int32 order
SIGN = -0x80000000
#: int64 sign bit: ``x ^ SIGN64`` maps u64 order onto int64 order
SIGN64 = -0x8000000000000000
U32_MASK = 0xFFFFFFFF
#: padding key of the sorted distinct-key array: all ones, u32 or u64, is
#: -1 on either carrier (the JAX package's ``ukey_pad(dtype)``); padding
#: groups also carry ``group_len == 0``
UKEY_PAD = -1


@dataclass(frozen=True)
class GroupIndex:
    """Distinct-key directory + CSR group storage over the build rows (the
    nested table's MainNode/SubNode layout, ``ht_nested.hh:111-183``).

    Directory arrays have length ``cap``; entries at or past ``n_keys`` are
    padding (``UKEY_PAD``, ``group_len`` 0).  ``group_rows`` holds the build
    row ids of each key ascending (the stable key sort's row payload).
    """

    ukey: torch.Tensor         # u32[cap] distinct keys, ascending, padded
    group_start: torch.Tensor  # i32[cap] offset of each key's rows
    group_len: torch.Tensor    # i32[cap] rows per key (0 for padding)
    group_rows: torch.Tensor   # i32[n] build row ids per key, ascending
    first_row: torch.Tensor    # i32[cap] first-inserted row per key
    gid_by_row: torch.Tensor   # i32[n] group of each row (or empty)
    n_keys: torch.Tensor       # i32[] number of distinct keys


def empty_group_index(n_keys: int, device) -> GroupIndex:
    """The directory of a dense-direct table: no arrays, ``n_keys`` keys."""
    empty = torch.zeros(0, dtype=I32, device=device)
    return GroupIndex(ukey=empty, group_start=empty, group_len=empty,
                      group_rows=empty, first_row=empty, gid_by_row=empty,
                      n_keys=torch.tensor(n_keys, dtype=I32, device=device))


def canon_key_dtype(keys) -> torch.dtype:
    """The key carrier of a column (tensor or numpy): int64 for 8-byte
    keys, int32 for the rest."""
    size = (keys.element_size() if isinstance(keys, torch.Tensor)
            else np.asarray(keys).dtype.itemsize)
    return I64 if size == 8 else I32


def check_carrier(keys: torch.Tensor) -> None:
    """Refuse a key tensor that is neither carrier (int32 or int64)."""
    if keys.dtype not in (I32, I64):
        raise TypeError(f"key columns ride int32 (u32) or int64 (u64) "
                        f"carriers, got {keys.dtype}")


def uorder(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its sign bit flipped: unsigned order as signed order."""
    return x ^ (SIGN64 if x.dtype == I64 else SIGN)


def pack2u32(hi, lo) -> np.ndarray:
    """Pack a composite (hi, lo) u32 key pair into one u64 join key (host
    columns in, a numpy uint64 column out)."""
    hi = np.asarray(hi).astype(np.uint32).astype(np.uint64)
    lo = np.asarray(lo).astype(np.uint32).astype(np.uint64)
    return (hi << np.uint64(32)) | lo


def key_column(a, device) -> torch.Tensor:
    """A host key column as its carrier on ``device``: 8-byte integers as
    int64 with the u64 bits, narrower integers as int32 with the bits of
    ``astype(uint32)`` (a signed column sign-extends first, as numpy and
    the JAX package cast it)."""
    a = np.asarray(a)
    if a.dtype.kind not in "iu":
        raise TypeError(f"expected an integer key column, got {a.dtype}")
    # astype copies, so the tensor never aliases the caller's column
    if canon_key_dtype(a) == I64:
        host = a.astype(np.uint64, order="C").view(np.int64)
    else:
        host = a.astype(np.uint32, order="C").view(np.int32)
    return torch.from_numpy(host).to(resolve_device(device))


def widen_u64(x: torch.Tensor) -> torch.Tensor:
    """A key carrier as int64: a u32 column zero-extends, never
    sign-extends."""
    return x if x.dtype == I64 else u32_to_i64(x)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device the host lacks
    (the port never falls back to the CPU silently)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def from_numpy_u32(a: np.ndarray, device) -> torch.Tensor:
    """A host u32 (or i32) column as the int32 carrier on ``device``."""
    a = np.ascontiguousarray(a)
    if a.dtype not in (np.uint32, np.int32):
        raise TypeError(f"expected a 32-bit integer column, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy()).to(resolve_device(device))


def u32_to_i64(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value of an int32 carrier, as int64."""
    return x.to(I64) & U32_MASK


def i64_to_u32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an int64 tensor as the int32 carrier."""
    x = x & U32_MASK
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(I32)


def shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of an int32 carrier by ``0 < k < 32``."""
    return (x >> k) & ((1 << (32 - k)) - 1)


def run_boundaries(skey: torch.Tensor, n_valid):
    """Run-length structure of a sorted key column, gather-free.

    Returns ``(is_first, gid, run_start, run_len)`` per sorted element from
    one fused forward scan (sum, max) and one reverse min scan
    (``ops/scan.py``, kernel K3 on the GPU).  ``n_valid`` counts the live
    leading elements: an int, or a device scalar (read by no host sync).
    """
    from .scan import multi_scan

    n = skey.shape[0]
    i = torch.arange(n, dtype=I32, device=skey.device)
    vs = i < n_valid
    is_first = torch.ones(n, dtype=torch.bool, device=skey.device)
    is_first[1:] = skey[1:] != skey[:-1]
    is_first &= vs
    gid1, run_start = multi_scan(
        (is_first.to(I32), torch.where(is_first, i, -1)), ("sum", "max"))
    gid = gid1 - 1
    # start of the NEXT run, filled from the right
    nxt = torch.full((n,), n, dtype=I32, device=skey.device)
    nxt[:-1] = torch.where(is_first, i, n)[1:]
    (nxt_min,) = multi_scan((nxt,), ("min",), reverse=True)
    next_start = (torch.minimum(nxt_min, n_valid.to(I32))
                  if isinstance(n_valid, torch.Tensor)
                  else torch.clamp(nxt_min, max=n_valid))
    run_len = torch.where(vs, next_start - run_start, 0)
    return is_first, gid, run_start, run_len


def sorted_histogram(b_sorted: torch.Tensor, num_buckets: int,
                     is_first: torch.Tensor, run_len: torch.Tensor):
    """Bucket histogram of an already-sorted bucket column: each run's
    length lands at its bucket (values >= ``num_buckets`` fall off an extra
    slot).  Returns ``(bucket_start, bucket_len)``, both int32[num_buckets].
    """
    tgt = torch.where(is_first, b_sorted, num_buckets).long()
    blen = torch.zeros(num_buckets + 1, dtype=I32, device=b_sorted.device)
    blen[tgt] = run_len.to(I32)
    blen = blen[:num_buckets]
    bstart = torch.cumsum(blen, 0, dtype=I32) - blen
    return bstart, blen


def inverse_permute(perm: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``out[perm[i]] = vals[i]`` for ``perm`` an exact permutation of
    [0, n)."""
    out = torch.empty_like(vals)
    out[perm.long()] = vals
    return out


def is_sorted_ascending(keys: torch.Tensor, unsigned: bool = True) -> bool:
    """True iff ``keys`` is ascending (unsigned order of its carrier by
    default)."""
    if keys.shape[0] < 2:
        return True
    k = uorder(keys) if unsigned else keys
    return host_read((k[1:] >= k[:-1]).all(), "sort.presorted")


def sort_rows_maybe_skip(keys: torch.Tensor):
    """Stable unsigned sort of ``keys`` (either carrier) with its row ids,
    skipped when ``keys`` is already ascending (a STABLE sort of an
    ascending stream is the identity, so the skip is exact).  Returns
    ``(sorted keys, rows)``."""
    if is_sorted_ascending(keys):
        return keys, torch.arange(keys.shape[0], dtype=I32,
                                  device=keys.device)
    s, idx = torch.sort(uorder(keys), stable=True)
    return uorder(s), idx.to(I32)


def sort_with_rows(keys: torch.Tensor):
    """Phase 1 of the compacted builds: ``(sorted keys, rows, n_keys)``,
    the distinct-key count a device scalar."""
    check_carrier(keys)
    skey, srow = sort_rows_maybe_skip(keys)
    n = skey.shape[0]
    if n == 0:
        return skey, srow, torch.zeros((), dtype=I32, device=keys.device)
    n_keys = (skey[1:] != skey[:-1]).sum(dtype=I32) + 1
    return skey, srow, n_keys


def group_capacity(n_keys: int, n: int) -> int:
    """Next power of two >= n_keys (bounded by n)."""
    return min(max(1, 1 << (int(n_keys) - 1).bit_length()), n)


def compact_group_index(keys: torch.Tensor, skey: torch.Tensor,
                        srow: torch.Tensor, cap: int, n_valid=None,
                        with_gid_by_row: bool = False,
                        row_values: torch.Tensor | None = None) -> GroupIndex:
    """A :class:`GroupIndex` with ``cap``-sized directory arrays, from the
    phase-1 sort (``skey``, ``srow``).  ``n_valid`` (default: every row)
    counts the live leading sorted rows; the rest join no group, and
    ``with_gid_by_row`` gives them group -1.  ``row_values`` (key-sorted,
    one a row) replaces the emitted ``group_rows``: a distributed shard
    passes its rows' global ids, so the strands emit global coordinates;
    ``first_row`` stays the local arrival row (chain order).

    The run heads' sorted positions scatter into the directory (group ids
    ascend with the sorted keys), then the key, run length and first row
    of each group are fetched at those positions: by ``safe_lookup`` (K2)
    while heads stride at most 8 rows per key, by a plain gather past that
    (the window would have to grow past its cap).  A 64-bit key is fetched
    as its two u32 halves.  ``gid_by_row`` is not materialised (no probe
    reads it) unless ``with_gid_by_row``.
    """
    n = keys.shape[0]
    dev = keys.device
    i = torch.arange(n, dtype=I32, device=dev)
    is_first, gid, _, run_len = run_boundaries(
        skey, n if n_valid is None else n_valid)
    if n == 0:
        ukey = torch.full((cap,), UKEY_PAD, dtype=skey.dtype, device=dev)
        group_start = torch.zeros(cap, dtype=I32, device=dev)
        group_len = torch.zeros(cap, dtype=I32, device=dev)
        first_row = torch.zeros(cap, dtype=I32, device=dev)
        n_keys = torch.zeros((), dtype=I32, device=dev)
    else:
        from .strands_windowed import safe_lookup, stride_params

        n_keys = torch.clamp(gid[-1] + 1, min=0)
        slot = torch.arange(cap, dtype=I32, device=dev)
        pad = slot >= torch.clamp(n_keys, max=cap)
        # heads past the directory (a too-small cap) drop, like the rest
        tgt = torch.where(is_first & (gid < cap), gid, cap + i)
        head = torch.full((cap + n,), n, dtype=I32, device=dev)
        head[tgt.long()] = i
        head = head[:cap]
        hp = torch.clamp(head, max=n - 1)
        stride = n / cap
        if stride <= 8:
            W, C = stride_params(stride, margin=2.0)

            def fetch(vals):
                return safe_lookup(vals, hp, W=W, C=C)
        else:
            def fetch(vals):
                return vals[hp.long()]
        if skey.dtype == I64:
            hi = fetch(i64_to_u32(skey >> 32))
            lo = fetch(i64_to_u32(skey))
            skey_hp = (hi.to(I64) << 32) | u32_to_i64(lo)
        else:
            skey_hp = fetch(skey)
        ukey = torch.where(pad, UKEY_PAD, skey_hp)
        group_start = torch.where(pad, n, head)
        group_len = torch.where(pad, 0, fetch(run_len))
        first_row = torch.where(pad, n, fetch(srow))
    gid_by_row = torch.zeros(0, dtype=I32, device=dev)
    if with_gid_by_row:
        live_gid = gid if n_valid is None else torch.where(i < n_valid, gid,
                                                           -1)
        gid_by_row = inverse_permute(srow, live_gid)
    return GroupIndex(ukey=ukey, group_start=group_start,
                      group_len=group_len,
                      group_rows=srow if row_values is None
                      else row_values.to(I32),
                      first_row=first_row, gid_by_row=gid_by_row,
                      n_keys=n_keys.to(I32))


def drop_pad_groups(groups: GroupIndex) -> GroupIndex:
    """Kill the group whose key is the all-ones pad value: its
    ``group_len`` goes to 0 (it enters no bucket, matches no probe,
    expands to nothing) and ``n_keys`` stops counting it.  A padded
    exchange receive parks its dead slots on that key
    (``parallel.shuffle.partition_exchange``), so the unmasked compacted
    build over it drops them here.  Directory padding already carries the
    pad key with ``group_len`` 0."""
    dead = groups.ukey == UKEY_PAD
    live_sentinel = dead & (groups.group_len > 0)
    return replace(groups,
                   group_len=torch.where(dead, 0, groups.group_len),
                   n_keys=(groups.n_keys
                           - live_sentinel.sum(dtype=I32)).to(I32))


def shrink_group_arrays(arrays: tuple, cap: int) -> tuple:
    """Slice directory-indexed arrays to ``cap`` entries.  Live groups
    occupy a prefix (group ids ascend with the sorted keys), so once the
    distinct count is known the slices are exact."""
    return tuple(a[:cap] for a in arrays)


def _stable_order(key: torch.Tensor, perm: torch.Tensor | None):
    """``perm`` followed by the stable ascending order of ``key[perm]``."""
    idx = torch.sort(key if perm is None else key[perm], stable=True).indices
    return idx if perm is None else perm[idx]


def key_order(keys: torch.Tensor, valid: torch.Tensor | None = None,
              values: torch.Tensor | None = None) -> torch.Tensor:
    """The rows' stable order by (dead, key, value): keys unsigned, the
    live rows under ``valid`` first, ``values`` in their own dtype's
    order.  One stable pass a sort key, least significant first; a u32
    key and its dead bit share one int64 word."""
    perm = None if values is None else _stable_order(values, None)
    if valid is None:
        return _stable_order(uorder(keys), perm)
    dead = (~valid).to(I64)
    if keys.dtype == I32:
        return _stable_order((dead << 32) | u32_to_i64(keys), perm)
    return _stable_order(dead, _stable_order(uorder(keys), perm))


def key_group_index(keys: torch.Tensor,
                    valid: torch.Tensor | None = None) -> GroupIndex:
    """Group the rows by exact key value: the n-sized directory of the
    clarity builds (``ht_nested.hh:286-311`` as one sort).

    A stable unsigned sort of the keys (live rows first under ``valid``,
    :func:`key_order`), then :func:`compact_group_index` at ``cap = n``;
    ``gid_by_row`` is -1 for a dead row and ``group_rows`` holds each
    key's rows ascending (:func:`emit_pos` gives the reference's [first,
    rest LIFO] order).
    """
    check_carrier(keys)
    order = key_order(keys, valid)
    n_valid = None if valid is None else valid.sum()
    return compact_group_index(keys, keys[order], order.to(I32),
                               keys.shape[0], n_valid=n_valid,
                               with_gid_by_row=True)


def emit_pos(within: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Offset into a group's ascending rows of emission slot ``within`` of
    a group of ``length`` rows: the reference emits [first-inserted row,
    the rest LIFO] (``ht_nested.hh:398-412``), so slot 0 reads offset 0
    and slot w > 0 reads ``length - w``."""
    return torch.where(within == 0, 0, length - within)


def key_direct_index(groups: GroupIndex, key_domain: int) -> torch.Tensor:
    """Dense key -> group map over the domain [0, ``key_domain``): one
    scatter at build time, one lookup a probe.  ``-1`` marks absent keys;
    keys at or past the domain (compared unsigned, so the padding key too)
    are left out."""
    cap = groups.ukey.shape[0]
    dev = groups.ukey.device
    slot = torch.arange(cap, dtype=I64, device=dev)
    uk = widen_u64(groups.ukey)
    # an int64 carrier below 0 is a u64 key of at least 2^63
    ok = (groups.group_len > 0) & (uk >= 0) & (uk < key_domain)
    tgt = torch.where(ok, uk, key_domain + slot)
    out = torch.full((key_domain + cap,), -1, dtype=I32, device=dev)
    out[tgt] = slot.to(I32)
    return out[:key_domain]


def same_key_width(build: torch.Tensor, pk: torch.Tensor) -> None:
    """Refuse probe keys of another carrier than the build side's: build
    and probe must hash with one functor width (``api.join`` widens both
    columns to u64 when either is 64-bit)."""
    if pk.dtype != build.dtype:
        raise ValueError(f"probe keys ride {pk.dtype}, the build side "
                         f"{build.dtype}: widen both columns to one key "
                         "width before the build")


def lookup(groups: GroupIndex, probe_keys: torch.Tensor):
    """Each probe key's group id by binary search over the sorted distinct
    keys: ``(g, hit)``.  A hit also needs a non-empty group: padding slots
    carry the all-ones key, which a probe may equal, but ``group_len`` 0
    (and a real key of that value sorts before its padding, so the left
    insertion point finds it first)."""
    same_key_width(groups.ukey, probe_keys)
    cap = groups.ukey.shape[0]
    g = torch.searchsorted(uorder(groups.ukey), uorder(probe_keys),
                           side="left").to(I32)
    g = torch.clamp(g, max=cap - 1)
    gl = g.long()
    hit = (groups.ukey[gl] == probe_keys) & (groups.group_len[gl] > 0)
    return g, hit


def merge_lookup(groups: GroupIndex, probe_keys: torch.Tensor,
                 mask: torch.Tensor | None = None):
    """Sort-merge twin of :func:`lookup`, same ``(g, hit)``: one stable
    sort of the directory keys and the probe keys (each directory entry
    before its equal probe keys), the last directory entry carried forward
    by running maxima, and one scatter back to probe order.  Padding
    directory slots stay out of the carry; the scatter sends directory
    entries to slots of their own past the probes."""
    same_key_width(groups.ukey, probe_keys)
    n = groups.ukey.shape[0]
    P = probe_keys.shape[0]
    dev = probe_keys.device
    vals = uorder(torch.cat([groups.ukey, probe_keys]))
    svals, order = torch.sort(vals, stable=True)
    dir_gid = torch.where(groups.group_len > 0,
                          torch.arange(n, dtype=I32, device=dev), -1)
    gid_in = torch.cat([dir_gid, torch.full((P,), -1, dtype=I32,
                                            device=dev)])
    sgid = gid_in[order]
    srow = order.to(I64) - n          # probe row, or < 0 for a directory slot
    is_dir = sgid >= 0
    g_prop = torch.cummax(sgid, 0).values
    # the carrier's minimum is the running maximum's identity
    floor = SIGN64 if vals.dtype == I64 else SIGN
    k_prop = torch.cummax(torch.where(is_dir, svals, floor), 0).values
    hit_s = ~is_dir & (k_prop == svals) & (g_prop >= 0)
    slot = torch.arange(n + P, dtype=I64, device=dev)
    tgt = torch.where(srow >= 0, srow, P + slot)
    g = torch.zeros(n + 2 * P, dtype=I32, device=dev)
    g[tgt] = torch.clamp(g_prop, min=0)
    hit = torch.zeros(n + 2 * P, dtype=torch.bool, device=dev)
    hit[tgt] = hit_s
    g, hit = g[:P], hit[:P]
    hit = hit & (groups.group_len[g.long()] > 0)
    if mask is not None:
        hit = hit & mask
    return g, hit


def lookup_auto(groups: GroupIndex, probe_keys: torch.Tensor,
                method: str = "auto"):
    """:func:`lookup` or :func:`merge_lookup`.  ``"auto"`` is the binary
    search on both device types: on the CPU as in the JAX package, and on
    CUDA because it measured 10-21x faster than the sort-merge on
    ``join``'s semi path on an NVIDIA H100 80GB HBM3 at 700 W
    (``chip_smoke.py`` phase 7, PERF.md §6; the JAX package's TPU rule
    picks the merge)."""
    if method == "auto":
        method = "search"
    if method == "merge":
        return merge_lookup(groups, probe_keys)
    if method != "search":
        raise ValueError(f"method must be 'auto', 'search' or 'merge', got "
                         f"{method!r}")
    return lookup(groups, probe_keys)


def key_direct_lookup(key_direct: torch.Tensor, probe_keys: torch.Tensor):
    """One-gather probe of a :func:`key_direct_index` map: ``(g, hit)``.
    Keys at or past the domain, compared unsigned, miss."""
    dom = key_direct.shape[0]
    pk = probe_keys
    in_dom = (pk >= 0) & (pk < dom)  # a negative carrier is >= 2^31 or 2^63
    g = torch.where(in_dom, key_direct[torch.clamp(pk, 0, dom - 1).long()],
                    -1)
    return torch.clamp(g, min=0), g >= 0


def expand(counts: torch.Tensor, out_size: int, payloads: tuple = (),
           with_seg_len: bool = False):
    """Variable-count segment expansion into ``out_size`` slots: output
    slot j maps to (segment p, position within it, valid).

    Each non-empty segment's rank is scattered to its first slot, a
    ``("max",)`` scan (K3) fills the segment ids forward, and the
    segment's start offset, every payload and, with ``with_seg_len``, the
    segment's (possibly cut) length ride ``safe_lookup`` (K2) keyed by the
    nondecreasing ``p``.  Returns ``(p, within, valid, total,
    *propagated_payloads[, seg_len])``; ``total`` is a device scalar.
    """
    from .scan import multi_scan
    from .strands_windowed import safe_lookup, stride_params

    counts = counts.to(I32)
    P = counts.shape[0]
    dev = counts.device
    cum = torch.cumsum(counts, 0, dtype=I32)
    total = cum[-1] if P > 0 else torch.zeros((), dtype=I32, device=dev)
    off = cum - counts
    rank = torch.arange(P, dtype=I32, device=dev)
    # empty segments and heads past the buffer drop
    tgt = torch.where((counts > 0) & (off < out_size), off, out_size + rank)
    head_p = torch.full((out_size + P,), -1, dtype=I32, device=dev)
    head_p[tgt.long()] = rank
    (p,) = multi_scan((head_p[:out_size],), ("max",))
    j = torch.arange(out_size, dtype=I32, device=dev)
    valid_p = p >= 0
    pc = torch.clamp(p, min=0)

    # p advances ~P/out_size per slot; the 2x margin absorbs the count
    # fluctuation (safe_lookup patches or falls back, and records it)
    Wp, Cp = stride_params(P / max(out_size, 1), margin=2.0)
    start = safe_lookup(off + 1, pc, W=Wp, C=Cp) - 1
    within = j - start
    valid = (j < total) & valid_p
    props = [safe_lookup(pay.to(I32), pc, W=Wp, C=Cp) for pay in payloads]
    if with_seg_len:
        seg_end = safe_lookup(cum + 1, pc, W=Wp, C=Cp) - 1
        seg_end = torch.minimum(seg_end, torch.clamp(total, max=out_size))
        props.append(torch.clamp(seg_end - start, min=0))
    return (pc, within, valid, total, *props)
