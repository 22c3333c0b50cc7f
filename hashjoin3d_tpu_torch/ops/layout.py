"""Integer carriers, the run-structure primitives and the CSR group layout.

Port of ``hashjoin3d_tpu/ops/layout.py`` (the parts the dense-direct builds,
the compacted nested build and the unnest expansion use).  PyTorch's
``uint32`` has no add, shifts, ``<``, ``%``, cummax or scatter, so every
u32 column rides as the int32 tensor with the same bits:

* add and multiply wrap exactly as u32;
* an unsigned compare or sort flips the sign bit first (``x ^ SIGN``);
* a logical right shift is :func:`shr`;
* arithmetic that must see the unsigned value widens to int64 with
  :func:`u32_to_i64` and comes back through :func:`i64_to_u32`.

Counters are int64.

Where the JAX package compacts run heads or places expansion heads with a
sort on the TPU, the port takes the scatter.  The scatters of
:func:`compact_group_index`, :func:`key_direct_index` and :func:`expand`
send the entries they drop to slots of their own past the kept range, not
all to one slot, so no two stores meet at one address.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

I32 = torch.int32
I64 = torch.int64
#: int32 sign bit: ``x ^ SIGN`` maps u32 order onto int32 order
SIGN = -0x80000000
U32_MASK = 0xFFFFFFFF
#: padding key of the sorted distinct-key array (u32 0xFFFFFFFF on the
#: carrier); padding groups also carry ``group_len == 0``
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


def canon_key_dtype(keys: torch.Tensor) -> torch.dtype:
    """The key carrier: int32 for 32-bit keys.  64-bit keys are not
    ported yet."""
    if keys.element_size() == 8:
        raise NotImplementedError(
            "64-bit keys come with ROADMAP slice 4 (the merged strands)")
    return I32


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
    """True iff ``keys`` is ascending (u32 order by default)."""
    if keys.shape[0] < 2:
        return True
    k = keys ^ SIGN if unsigned else keys
    return bool((k[1:] >= k[:-1]).all())


def sort_rows_maybe_skip(keys: torch.Tensor):
    """Stable u32 sort of ``keys`` with its row ids, skipped when ``keys``
    is already ascending (a STABLE sort of an ascending stream is the
    identity, so the skip is exact).  Returns ``(sorted keys, rows)``."""
    if is_sorted_ascending(keys):
        return keys, torch.arange(keys.shape[0], dtype=I32,
                                  device=keys.device)
    s, idx = torch.sort(keys ^ SIGN, stable=True)
    return s ^ SIGN, idx.to(I32)


def sort_with_rows(keys: torch.Tensor):
    """Phase 1 of the compacted builds: ``(sorted keys, rows, n_keys)``,
    the distinct-key count a device scalar."""
    canon_key_dtype(keys)
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
                        srow: torch.Tensor, cap: int) -> GroupIndex:
    """A :class:`GroupIndex` with ``cap``-sized directory arrays, from the
    phase-1 sort (``skey``, ``srow``).

    The run heads' sorted positions scatter into the directory (group ids
    ascend with the sorted keys), then the key, run length and first row
    of each group are fetched at those positions: by ``safe_lookup`` (K2)
    while heads stride at most 8 rows per key, by a plain gather past that
    (the window would have to grow past its cap).  ``gid_by_row`` is not
    materialised (no probe reads it).
    """
    n = keys.shape[0]
    dev = keys.device
    i = torch.arange(n, dtype=I32, device=dev)
    is_first, gid, _, run_len = run_boundaries(skey, n)
    if n == 0:
        ukey = torch.full((cap,), UKEY_PAD, dtype=I32, device=dev)
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
        ukey = torch.where(pad, UKEY_PAD, fetch(skey))
        group_start = torch.where(pad, n, head)
        group_len = torch.where(pad, 0, fetch(run_len))
        first_row = torch.where(pad, n, fetch(srow))
    return GroupIndex(ukey=ukey, group_start=group_start,
                      group_len=group_len, group_rows=srow,
                      first_row=first_row,
                      gid_by_row=torch.zeros(0, dtype=I32, device=dev),
                      n_keys=n_keys.to(I32))


def key_direct_index(groups: GroupIndex, key_domain: int) -> torch.Tensor:
    """Dense key -> group map over the domain [0, ``key_domain``): one
    scatter at build time, one lookup a probe.  ``-1`` marks absent keys;
    keys at or past the domain (compared unsigned, so the padding key
    0xFFFFFFFF too) are left out."""
    cap = groups.ukey.shape[0]
    dev = groups.ukey.device
    slot = torch.arange(cap, dtype=I64, device=dev)
    uk = u32_to_i64(groups.ukey)
    ok = (groups.group_len > 0) & (uk < key_domain)
    tgt = torch.where(ok, uk, key_domain + slot)
    out = torch.full((key_domain + cap,), -1, dtype=I32, device=dev)
    out[tgt] = slot.to(I32)
    return out[:key_domain]


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
