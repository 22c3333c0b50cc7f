"""Hash aggregate: a group-by over a key column.

Port of ``hashjoin3d_tpu/ops/aggregate.py``.  Each value column sorts with
the keys (dead rows last under a ``mask``); the run structure of the
sorted keys (K3) gives the groups, and each group's count, sum, min and
max fall out at its run's ends: values ascend within a run, and a sum is
the difference of an accumulated prefix.  Integer columns accumulate in
int64 (exact), float columns in float64.  Results are directory-major:
``cap`` slots, the first ``n_keys`` live; an ``n_keys`` hint (exact or
larger) makes ``cap`` its power-of-two ceiling.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .layout import (I32, I64, UKEY_PAD, GroupIndex, check_carrier,
                     group_capacity, key_order, run_boundaries)


@dataclass(frozen=True)
class AggregateResult:
    """Per-distinct-key aggregates; slots at or past ``n_keys`` are
    padding.  ``groups`` holds the directory (``ukey``, ``group_start``,
    ``group_len``); its row-level arrays are empty."""

    groups: GroupIndex
    count: torch.Tensor  # i32[cap]
    sums: dict           # name -> i64[cap] (float64 for float columns)
    mins: dict           # name -> the column's dtype [cap]
    maxs: dict           # name -> the column's dtype [cap]

    @property
    def keys(self) -> torch.Tensor:
        return self.groups.ukey

    @property
    def n_keys(self) -> torch.Tensor:
        return self.groups.n_keys


def _acc_and_bounds(dtype: torch.dtype):
    """(accumulator dtype, the empty group's min, its max) of a column."""
    if dtype.is_floating_point:
        return torch.float64, float("inf"), float("-inf")
    info = torch.iinfo(dtype)
    return I64, info.max, info.min


def hash_aggregate(keys: torch.Tensor, values: dict,
                   mask: torch.Tensor | None = None,
                   n_keys: int | None = None) -> AggregateResult:
    """Group ``values`` (a dict of equal-length columns) by ``keys`` (a key
    carrier); count, sum, min and max per key.  ``mask`` leaves rows out;
    ``n_keys`` (exact or larger) compacts the directory, and a smaller
    hint truncates it."""
    check_carrier(keys)
    n = keys.shape[0]
    dev = keys.device
    cap = n if n_keys is None else group_capacity(n_keys, n)
    names = sorted(values)
    cols = [values[k] for k in names]
    n_valid = n if mask is None else mask.sum()

    if n == 0:
        zeros = torch.zeros(cap, dtype=I32, device=dev)
        sums, mins, maxs = {}, {}, {}
        for name, col in zip(names, cols):
            acc, big, small = _acc_and_bounds(col.dtype)
            sums[name] = torch.zeros(cap, dtype=acc, device=dev)
            mins[name] = torch.full((cap,), big, dtype=col.dtype, device=dev)
            maxs[name] = torch.full((cap,), small, dtype=col.dtype,
                                    device=dev)
        empty = torch.zeros(0, dtype=I32, device=dev)
        groups = GroupIndex(
            ukey=torch.full((cap,), UKEY_PAD, dtype=keys.dtype, device=dev),
            group_start=zeros, group_len=zeros, group_rows=empty,
            first_row=empty, gid_by_row=empty,
            n_keys=torch.zeros((), dtype=I32, device=dev))
        return AggregateResult(groups=groups, count=zeros, sums=sums,
                               mins=mins, maxs=maxs)

    sorted_cols = []
    skey = None
    for col in cols:
        order = key_order(keys, mask, col)
        skey = keys[order]  # the same for every column: same major keys
        sorted_cols.append(col[order])
    if skey is None:  # count only
        skey = keys[key_order(keys, mask)]

    is_first, gid, _, run_len = run_boundaries(skey, n_valid)
    # an undershooting hint truncates the directory: count what it holds
    n_groups = torch.clamp(gid[-1] + 1, 0, cap)
    i = torch.arange(n, dtype=I32, device=dev)
    tgt = torch.where(is_first & (gid < cap), gid, cap + i).long()
    head = torch.full((cap + n,), n, dtype=I32, device=dev)
    head[tgt] = i
    head = head[:cap]
    pad = torch.arange(cap, dtype=I32, device=dev) >= n_groups
    hp = torch.clamp(head, max=n - 1).long()
    glen = torch.where(pad, 0, run_len[hp])
    ukey = torch.where(pad, UKEY_PAD, skey[hp])
    gvalid = glen > 0
    startpos = torch.where(gvalid, head, 0).long()
    endpos = torch.clamp(torch.where(gvalid, head + glen - 1, 0),
                         max=n - 1).long()

    sums, mins, maxs = {}, {}, {}
    for name, col_s in zip(names, sorted_cols):
        acc, big, small = _acc_and_bounds(col_s.dtype)
        cs = torch.cumsum(col_s.to(acc), 0)
        before = torch.where(startpos > 0,
                             cs[torch.clamp(startpos - 1, min=0)], 0)
        sums[name] = torch.where(gvalid, cs[endpos] - before, 0).to(acc)
        # values ascend within each run: min at its head, max at its tail
        mins[name] = torch.where(gvalid, col_s[startpos], big).to(col_s.dtype)
        maxs[name] = torch.where(gvalid, col_s[endpos], small).to(col_s.dtype)
    empty = torch.zeros(0, dtype=I32, device=dev)
    groups = GroupIndex(ukey=ukey, group_start=torch.where(pad, n, head),
                        group_len=glen, group_rows=empty, first_row=empty,
                        gid_by_row=empty, n_keys=n_groups.to(I32))
    return AggregateResult(groups=groups, count=glen, sums=sums, mins=mins,
                           maxs=maxs)
