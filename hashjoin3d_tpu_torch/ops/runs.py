"""The runs of a sorted column in one pass (kernel RL, ``csrc/runs.cu``).

The compacted builds turn a sorted column into its runs twice:
:func:`run_directory` gives the directory of the sorted keys (each run's
key, start, length and first row at its ordinal, ``cap`` slots, the pad
values past the last run, the run count and optionally each element's
ordinal), :func:`run_histogram` the length of each run of sorted bucket ids
at its bucket and each element's rank in its run, written through a
permutation.  A run starts where the value changes; ``n_valid`` cuts the
column to its live prefix, and in the histogram a value at or past
``num_buckets`` joins no run.

On CUDA tensors each call launches RL (the directory a second, small kernel
for the pad slots); nothing is read back to the host.  Its look-back status
(one word a tile) is kept per CUDA stream, zeroed once when allocated, and
the kernel leaves it clean for the next call.  On CPU tensors the calls run
:func:`run_directory_plain` and :func:`run_histogram_plain`, the exact
PyTorch versions.

:func:`main_chains` gives a compacted directory its main chains with no
sort: each live group's rank by first row among the live groups of its
bucket, and each bucket's count (kernel MC of the same source: a
histogram, the buckets' starts chained by RL's look-back status, a slot
claim and a count in each bucket; the buckets too long to count spread
over the whole grid, tile sorts, then merge passes).  The nested builds'
``_main_chains`` calls it; on CPU tensors it runs
:func:`main_chains_plain`, the composition MC replaced: a stable sort of
(bucket, first row) and :func:`run_histogram_plain`.
"""

from __future__ import annotations

import operator

import torch

from .. import kernels
from .layout import I32, I64, UKEY_PAD
from .scan import scan_plan

_RL = kernels.Kernel("hj3t_runs")
_MC = kernels.Kernel("hj3t_main_chains")
_TILE = 0
#: (device index, stream handle) -> (capacity in tiles, data_ptr, tensor)
_WORKSPACES: dict = {}
_DIRECTORY, _HISTOGRAM = 0, 1
_LIMIT = (1 << 31) - 1
_U32 = 0xFFFFFFFF


def tile() -> int:
    """Elements a tile of the kernel, read once from ``csrc/runs.cu``."""
    global _TILE
    if not _TILE:
        _TILE = kernels.lib().hj3t_runs_tile()
    return _TILE


def _workspace(dev: int, stream: int, n: int, like: torch.Tensor):
    """The stream's status words as ``(capacity in tiles, data_ptr)``,
    grown (and zeroed) when ``n`` needs more tiles than they hold."""
    ws = _WORKSPACES.get((dev, stream))
    cap = ws[0] if ws is not None else 0
    _, need = scan_plan(n, tile(), cap)
    if need != cap:
        buf = torch.zeros(1 + need, dtype=I64, device=like.device)
        ws = _WORKSPACES[(dev, stream)] = (need, buf.data_ptr(), buf)
    return ws[0], ws[1]


def _check_column(values: torch.Tensor, dtypes, what: str) -> None:
    if values.dim() != 1 or values.dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"{what} must be a 1-D {names} tensor")
    if values.shape[0] >= _LIMIT:
        raise ValueError(f"{what} must hold fewer than 2^31 - 1 elements")


def _slots(slots, low: int, what: str) -> int:
    """``slots`` as an int in [``low``, 2^31), or raise."""
    try:
        s = operator.index(slots)
    except TypeError:
        s = None
    if s is None or not low <= s < 1 << 31:
        raise ValueError(f"{what} {slots!r} must be an int in [{low}, 2^31)")
    return s


def _n_valid_arg(n_valid, n: int):
    """``(immediate, device scalar or None, its bytes)`` for the kernel."""
    if n_valid is None:
        return n, None, 0
    if isinstance(n_valid, torch.Tensor):
        if n_valid.numel() != 1 or n_valid.dtype not in (I32, I64):
            raise ValueError("n_valid must be an int or a one-element int32 "
                             "or int64 tensor")
        return 0, n_valid, n_valid.element_size()
    return int(n_valid), None, 0


def run_directory(skey: torch.Tensor, srow: torch.Tensor, cap: int,
                  n_valid=None, with_gid: bool = False):
    """The run directory of the sorted keys ``skey`` (either carrier) with
    their rows ``srow`` (int32): ``(ukey, group_start, group_len,
    first_row, n_keys, gid)``.

    The run of ordinal g < ``cap`` has its key at ``ukey[g]``, its first
    sorted position at ``group_start[g]``, its length at ``group_len[g]``
    and the row of its first position at ``first_row[g]``; slots from
    ``min(n_keys, cap)`` on hold the pad values (``UKEY_PAD``, n, 0, n), and
    runs past ``cap`` drop.  ``n_keys`` (an int32 device scalar) counts
    every run.  Only the first ``n_valid`` sorted elements (an int or a
    one-element device tensor; default all) join runs.  ``gid`` (int32[n]
    with ``with_gid``, else empty) is each element's run ordinal, -1 past
    ``n_valid``."""
    _check_column(skey, (I32, I64), "skey")
    _check_column(srow, (I32,), "srow")
    if srow.shape != skey.shape:
        raise ValueError("srow must be shaped like skey")
    cap = _slots(cap, 0, "cap")
    n = skey.shape[0]
    imm, nv_t, nv_bytes = _n_valid_arg(n_valid, n)
    extra = () if nv_t is None else (nv_t,)
    dev = kernels.kernel_device("runs", skey, srow, *extra)
    if dev < 0:
        return run_directory_plain(skey, srow, cap, n_valid, with_gid)
    ukey = torch.empty(cap, dtype=skey.dtype, device=skey.device)
    group_start, group_len, first_row = (
        torch.empty(cap, dtype=I32, device=skey.device) for _ in range(3))
    n_keys = torch.empty((), dtype=I32, device=skey.device)
    gid = torch.empty(n if with_gid else 0, dtype=I32, device=skey.device)
    stream = kernels.stream(dev)
    ws_cap, ws = _workspace(dev, stream, n, skey)
    _RL("runs", skey.data_ptr(), skey.element_size(), n, imm,
        None if nv_t is None else nv_t.data_ptr(), nv_bytes, cap,
        _DIRECTORY, srow.data_ptr(), None, ukey.data_ptr(),
        group_start.data_ptr(), group_len.data_ptr(), first_row.data_ptr(),
        n_keys.data_ptr(), gid.data_ptr() if with_gid else None, None, ws,
        ws_cap, stream)
    return ukey, group_start, group_len, first_row, n_keys, gid


def run_histogram(values: torch.Tensor, perm: torch.Tensor,
                  num_buckets: int):
    """The runs of the sorted bucket ids ``values`` (int32):
    ``(bucket_len, rank)``.  ``bucket_len[b]`` (int32[num_buckets]) is the
    length of the run of value b, 0 where there is none; values at or past
    ``num_buckets`` (compared unsigned) join no run.  ``rank[perm[i]]``
    (int32[n]) is element i's distance from the last run start at or
    before it (i + 1 before the first); ``perm`` (int64, as ``torch.sort``
    gives its order) is a permutation of [0, n)."""
    _check_column(values, (I32,), "values")
    _check_column(perm, (I64,), "perm")
    if perm.shape != values.shape:
        raise ValueError("perm must be shaped like values")
    num_buckets = _slots(num_buckets, 1, "num_buckets")
    dev = kernels.kernel_device("runs", values, perm)
    if dev < 0:
        return run_histogram_plain(values, perm, num_buckets)
    n = values.shape[0]
    bucket_len = torch.empty(num_buckets, dtype=I32, device=values.device)
    rank = torch.empty(n, dtype=I32, device=values.device)
    stream = kernels.stream(dev)
    ws_cap, ws = _workspace(dev, stream, n, values)
    _RL("runs", values.data_ptr(), 4, n, n, None, 0, num_buckets,
        _HISTOGRAM, None, perm.data_ptr(), None, None, bucket_len.data_ptr(),
        None, None, None, rank.data_ptr(), ws, ws_cap, stream)
    return bucket_len, rank


def _runs_plain(v: torch.Tensor, live: torch.Tensor, i: torch.Tensor):
    """``(head, tail, ordinal, start)`` per element of ``v`` (positions
    ``i``) given its ``live`` mask, as RL defines them."""
    differs = v[1:] != v[:-1]
    head = live.clone()
    head[1:] &= differs
    tail = live.clone()
    tail[:-1] &= differs | ~live[1:]
    ordinal = torch.cumsum(head, 0, dtype=I32) - 1
    start = torch.cummax(torch.where(head, i, -1), 0).values
    return head, tail, ordinal, start


def _put(mask, slot, vals, size: int, fill, dtype):
    """A ``size`` array of ``fill`` with ``vals`` at ``slot`` where
    ``mask``; the rest of the entries go to slots of their own past it."""
    n = vals.shape[0]
    past = size + torch.arange(n, dtype=I64, device=vals.device)
    out = torch.full((size + n,), fill, dtype=dtype, device=vals.device)
    out[torch.where(mask, slot.to(I64), past)] = vals.to(dtype)
    return out[:size]


def run_directory_plain(skey, srow, cap: int, n_valid=None,
                        with_gid: bool = False):
    """Exact PyTorch version of :func:`run_directory` (any device)."""
    n = skey.shape[0]
    i = torch.arange(n, dtype=I32, device=skey.device)
    live = i < (n if n_valid is None else n_valid)
    head, tail, ordinal, start = _runs_plain(skey, live, i)
    kept = ordinal < cap
    ukey = _put(head & kept, ordinal, skey, cap, UKEY_PAD, skey.dtype)
    group_start = _put(head & kept, ordinal, i, cap, n, I32)
    group_len = _put(tail & kept, ordinal, i - start + 1, cap, 0, I32)
    first_row = _put(head & kept, ordinal, srow, cap, n, I32)
    n_keys = head.sum(dtype=I32)
    gid = (torch.where(live, ordinal, -1) if with_gid
           else torch.zeros(0, dtype=I32, device=skey.device))
    return ukey, group_start, group_len, first_row, n_keys, gid


def run_histogram_plain(values, perm, num_buckets: int):
    """Exact PyTorch version of :func:`run_histogram` (any device)."""
    i = torch.arange(values.shape[0], dtype=I32, device=values.device)
    live = (values >= 0) & (values < num_buckets)  # unsigned: u32 < nb
    _, tail, _, start = _runs_plain(values, live, i)
    bucket_len = _put(tail, values, i - start + 1, num_buckets, 0, I32)
    rank = torch.empty_like(i)
    rank[perm.long()] = i - start
    return bucket_len, rank


def main_chains(bucket: torch.Tensor, first_row: torch.Tensor,
                num_buckets: int):
    """The main chains of a directory: ``(pos, bucket_len)``.
    ``bucket`` (int32[cap]) holds each group's bucket id, a value at or
    past ``num_buckets`` (compared unsigned) marking a dead group;
    ``first_row`` (int32[cap], >= 0 where live) each group's first row.
    ``bucket_len[b]`` counts the live groups in bucket b.  A live group's
    ``pos`` counts the live groups of its bucket with a smaller (first row,
    group id): its rank in first-occurrence order.  A dead group gets its
    distance from the start of the last non-empty bucket's run in (bucket,
    first row) order, as :func:`main_chains_plain` gives it, where the
    dead groups are the directory's tail and stand in that order, as in
    every build (MC writes g minus that start, g + 1 with no live
    group)."""
    _check_column(bucket, (I32,), "bucket")
    _check_column(first_row, (I32,), "first_row")
    if first_row.shape != bucket.shape:
        raise ValueError("first_row must be shaped like bucket")
    num_buckets = _slots(num_buckets, 1, "num_buckets")
    dev = kernels.kernel_device("main_chains", bucket, first_row)
    if dev < 0:
        return main_chains_plain(bucket, first_row, num_buckets)
    cap = bucket.shape[0]
    pos = torch.empty(cap, dtype=I32, device=bucket.device)
    bucket_len = torch.empty(num_buckets, dtype=I32, device=bucket.device)
    size = kernels.lib().hj3t_main_chains_scratch(cap, num_buckets)
    scratch = torch.empty((size + 7) // 8, dtype=I64, device=bucket.device)
    stream = kernels.stream(dev)
    ws_cap, ws = _workspace(dev, stream, num_buckets, bucket)
    _MC("main_chains", bucket.data_ptr(), first_row.data_ptr(), cap,
        num_buckets, bucket_len.data_ptr(), pos.data_ptr(),
        scratch.data_ptr(), 8 * scratch.shape[0], ws, ws_cap, stream)
    return pos, bucket_len


def main_chains_plain(bucket, first_row, num_buckets: int):
    """Exact PyTorch version of :func:`main_chains` (any device): the
    groups sorted stably by (bucket, first row) packed in an int64 word,
    and :func:`run_histogram_plain` over the sorted buckets."""
    packed = ((bucket.to(I64) & _U32) << 32) | (first_row.to(I64) & _U32)
    pk_s, gid_s = torch.sort(packed, stable=True)
    bucket_len, pos = run_histogram_plain((pk_s >> 32).to(I32), gid_s,
                                          num_buckets)
    return pos, bucket_len
