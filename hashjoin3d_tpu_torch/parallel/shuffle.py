"""Hash-partition shuffle: the distributed exchange under every parallel
join.

Port of ``hashjoin3d_tpu/parallel/shuffle.py``.  Rows go to the shard
owning their join key (``shard = hash(hash(key)) % n_shards``, the
width-matched finalizer, double-hashed so shard routing is decorrelated
from the in-table bucket ``h % num_buckets``): one stable sort by
destination, each row's rank within its destination from the sorted
runs (``layout.run_boundaries``, K3 on the GPU), a fixed-capacity
``[n_shards, capacity]`` send tensor a column, and one
``all_to_all_single`` a column on the axis's process group.

Static capacities: rows past a destination's ``capacity`` are dropped and
*counted* (``overflow``), never hidden; callers size the capacity from the
expected distribution and check ``overflow == 0``.  Dead receive slots
carry the all-ones key (which the key domain cannot contain) and -1
payloads.  64-bit keys ship as their int64 carrier (the JAX package's
(hi, lo) u32 halves were a TPU workaround); the arrival order is the JAX
package's, so a table built in arrival order compares ``num_cmps`` bit
for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.hashing import bucket_of, hash_key
from ..ops.layout import (I32, I64, UKEY_PAD, check_carrier, run_boundaries,
                          uorder)
from ..utils.tracing import span


def shard_of_key(keys: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Owning shard of each key: the double murmur of the key's own width
    (u64 keys never truncate to u32), modulo ``num_shards``, int32."""
    check_carrier(keys)
    return bucket_of(hash_key(hash_key(keys)), num_shards)


def exchange_order(dest: torch.Tensor, key_cols=()) -> torch.Tensor:
    """The stable order by destination, then by each key column taken
    unsigned (``sort_within_dest``): one stable pass a column, least
    significant first."""
    order = None
    for col in reversed(key_cols):
        k = uorder(col) if order is None else uorder(col[order])
        idx = torch.sort(k, stable=True).indices
        order = idx if order is None else order[idx]
    d = dest if order is None else dest[order]
    idx = torch.sort(d, stable=True).indices
    return idx if order is None else order[idx]


def pack_by_dest(dest: torch.Tensor, cols, fills, num_groups: int,
                 capacity: int, valid: torch.Tensor | None = None,
                 sort_cols: int = 0):
    """Pack rows into ``[num_groups * capacity]`` send columns by
    destination: ``(send columns, send valid (int32), local overflow)``.

    Rows are ordered stably by ``dest`` (dead rows, ``valid`` False, park
    past the last group), and by the first ``sort_cols`` columns, unsigned,
    within a destination.  A row's slot is its rank within its
    destination (the sorted runs' starts, K3); rows past ``capacity`` are
    dropped and counted.  Empty slots hold each column's ``fill``."""
    n = dest.shape[0]
    dev = dest.device
    if valid is not None:
        dest = torch.where(valid, dest, num_groups)
    order = exchange_order(dest, tuple(cols[:sort_cols]))
    dest_s = dest[order]
    _, _, run_start, _ = run_boundaries(dest_s, n)
    i = torch.arange(n, dtype=I32, device=dev)
    within = i - run_start
    live = dest_s < num_groups
    fits = live & (within < capacity)
    overflow = (live & ~fits).sum(dtype=I64)
    size = num_groups * capacity
    # dropped rows go to slots of their own past the send buffer
    tgt = torch.where(fits, dest_s * capacity + within, size + i).long()

    def pack(col_s, fill):
        buf = torch.full((size + n,), fill, dtype=col_s.dtype, device=dev)
        buf[tgt] = col_s
        return buf[:size]

    send = [pack(c[order], f) for c, f in zip(cols, fills)]
    send_valid = pack(fits.to(I32), 0)
    return send, send_valid, overflow


def all_to_all(cols, group, async_op: bool = False):
    """One ``all_to_all_single`` a column, equal splits: block d of each
    send column goes to rank d of ``group``; the receive holds one block
    from every rank, in rank order.  Returns ``(received columns,
    work handles)``; the handles are empty unless ``async_op``, and the
    columns may be read only after every handle's ``wait()``."""
    recv, works = [], []
    for c in cols:
        out = torch.empty_like(c)
        w = dist.all_to_all_single(out, c, group=group, async_op=async_op)
        recv.append(out)
        if async_op:
            works.append(w)
    return recv, works


class PendingExchange:
    """An exchange whose collectives were issued with ``async_op``:
    :meth:`wait` blocks on them (on CUDA: makes the current stream wait)
    and returns what :func:`partition_exchange` returns."""

    def __init__(self, names, recv, works, overflow):
        self._names, self._recv, self._works = names, recv, works
        self._overflow = overflow

    def wait(self):
        for w in self._works:
            w.wait()
        keys_r, valid_r, *pay = self._recv
        return (keys_r, dict(zip(self._names, pay)), valid_r > 0,
                self._overflow)


def partition_exchange(group, keys: torch.Tensor, payloads: dict,
                       num_shards: int, capacity: int,
                       valid: torch.Tensor | None = None,
                       sort_within_dest: bool = False,
                       reduce_overflow: bool = True,
                       async_op: bool = False):
    """Exchange rows to their key-owning shards over ``group``.

    Args (this rank's local columns):
      keys:     a key carrier (int32 for u32 keys, int64 for u64)
      payloads: dict of 32-bit columns shipped alongside (global row ids)
      capacity: rows accepted per (source, destination) pair
      valid:    rows to ship (default all); the rest never leave
      sort_within_dest: also order rows by key (unsigned) within each
        destination, so the receive arrives as ``num_shards`` ascending
        blocks with their dead slots, on the all-ones key, at each
        block's tail: the presorted layout the windowed strands consume
        without a local sort (``presorted=True``).
      reduce_overflow: ``all_reduce`` the dropped-row count over the
        group (the JAX package's psum); False returns this rank's count,
        for a caller that folds it into its own counter reduction.
      async_op: issue the collectives asynchronously and return a
        :class:`PendingExchange`, whose ``wait()`` gives the result (the
        overflow is then this rank's count).

    Returns ``(keys_recv, payloads_recv, valid_recv, overflow)``, the
    receive columns ``num_shards * capacity`` long, ``overflow`` an int64
    device scalar (must be 0 for a lossless exchange).
    """
    check_carrier(keys)
    names = sorted(payloads)
    with span("hj.exchange"):
        with span("hj.exchange.route"):
            dest = shard_of_key(keys, num_shards)
        with span("hj.exchange.pack"):
            cols = [keys, *(payloads[k].to(I32) for k in names)]
            fills = [UKEY_PAD, *([-1] * len(names))]
            send, send_valid, overflow = pack_by_dest(
                dest, cols, fills, num_shards, capacity, valid,
                sort_cols=1 if sort_within_dest else 0)
        with span("hj.exchange.all_to_all"):
            recv, works = all_to_all([send[0], send_valid, *send[1:]], group,
                                     async_op=async_op)
            pending = PendingExchange(names, recv, works, overflow)
            if async_op:
                return pending
            keys_r, payloads_r, valid_r, overflow = pending.wait()
        if reduce_overflow:
            with span("hj.exchange.reduce"):
                dist.all_reduce(overflow, group=group)
        return keys_r, payloads_r, valid_r, overflow
