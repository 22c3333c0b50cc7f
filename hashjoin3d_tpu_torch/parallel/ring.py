"""Ring-scheduled distributed probe: the join analogue of ring attention.

Port of ``hashjoin3d_tpu/parallel/ring.py``.  The build tables stay
resident (one hash partition a shard) and the probe chunks circulate:
each shard probes the chunk visiting it, then forwards it to the next
rank; after ``n_shards`` steps every chunk has met every table once.
Probe rows never move by key, so a shard's receive volume is uniform
whatever the key skew; the price is ``n_shards`` local probes a chunk.

``lax.ppermute`` to the next rank becomes one ``all_to_all_single`` whose
splits are zero except toward rank + 1 (and from rank - 1): one code path
for NCCL and gloo.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.layout import I64
from ..ops.nested import probe_nested, unnest
from ..ops.strands_windowed import (_sort_probes,
                                    keydirect_nested_strand_sorted)
from .dist_join import (_Appender, _check_columns, _global_rows, _map_rows,
                        _nested_table, _reduce)
from .mesh import SHARD_AXIS, axis_info
from .shuffle import partition_exchange


def ring_forward(x: torch.Tensor, group, size: int, index: int,
                 async_op: bool = False):
    """Send ``x`` to rank ``index + 1`` of ``group`` and receive the same
    length from rank ``index - 1``: ``(received, work or None)``; with
    ``async_op`` read the result only after ``work.wait()``."""
    n = x.shape[0]
    send = [0] * size
    recv = [0] * size
    send[(index + 1) % size] = n
    recv[(index - 1) % size] = n
    out = torch.empty_like(x)
    work = dist.all_to_all_single(out, x, recv, send, group=group,
                                  async_op=async_op)
    return out, work


def dist_ring_nested_join(mesh, num_buckets_per_shard: int,
                          build_capacity: int, out_capacity: int,
                          step_out_capacity: int | None = None,
                          axis: str = SHARD_AXIS, prefetch: bool = True,
                          key_domain: int | None = None,
                          n_keys: int | None = None):
    """A ring-scheduled distributed 3D-hash-join step.

    ``step(build_keys, probe_keys) -> dict``, the contract of
    :func:`~.dist_join.dist_nested_join` (global counters on every rank,
    this shard's global-id pairs, ``out_valid``, ``overflow``).  The
    build side is exchanged once; the probe chunks circulate instead.
    ``step_out_capacity`` bounds one (chunk, shard) probe's unnest
    (default ``out_capacity``), ``out_capacity`` the shard's total over
    all steps; pairs cut by either count as overflow.

    ``prefetch`` issues the hop that ships chunk k+1 (``async_op``)
    before step k's probe, and waits on it only when the next step reads
    the chunk; ``prefetch=False`` keeps the strictly sequential order.
    ``key_domain`` sorts each chunk once at home (``_sort_probes``: K1
    where the segment policy allows) and every visit probes it presorted
    through the windowed strand, the sort's window and segment and the
    chunk's global ids travelling with it.  ``n_keys`` takes the fused
    compacted resident build, as in ``dist_nested_join``.
    """
    group, ns, index = axis_info(mesh, axis)
    step_cap = out_capacity if step_out_capacity is None else \
        step_out_capacity

    def step(build_keys, probe_keys):
        _check_columns(build_keys, probe_keys)
        dev = build_keys.device
        np_local = probe_keys.shape[0]
        bkeys, bpay, bvalid, bovf = partition_exchange(
            group, build_keys,
            {"row": _global_rows(build_keys.shape[0], index, dev)}, ns,
            build_capacity, reduce_overflow=False)
        table = _nested_table(bkeys, bpay["row"], bvalid,
                              num_buckets_per_shard, key_domain, n_keys)

        vkeys = probe_keys
        vrow = _global_rows(np_local, index, dev)
        if key_domain is not None:
            # sorted once at home; the global ids follow from the sort's
            # rows arithmetically
            vkeys, sr, lookup_w, segment = _sort_probes(vkeys,
                                                        domain=key_domain)
            vrow = index * np_local + sr

        out = _Appender(out_capacity, step_cap, dev)
        counts = torch.zeros(3, dtype=I64, device=dev)  # m, cmps, unnested
        for k in range(ns):
            last = k + 1 == ns
            if prefetch and not last:
                # the hop depends only on the chunk: it overlaps the probe
                nkeys, wk = ring_forward(vkeys, group, ns, index, True)
                nrow, wr = ring_forward(vrow, group, ns, index, True)
            if key_domain is not None:
                o = keydirect_nested_strand_sorted(
                    table, vkeys, step_cap, presorted=True,
                    lookup_w=lookup_w, segment=segment, srow_values=vrow)
                prow_g, brow_l = o["probe_row"], o["build_row"]
                ovalid = prow_g >= 0
                total = o["c_unnest"]
                m, c = o["c_htProbe"], o["c_htProbeCmp"]
            else:
                res = probe_nested(table, vkeys)
                prow_l, brow_l, ovalid, total = unnest(table, res, step_cap)
                prow_g = _map_rows(vrow, prow_l, ovalid)
                m, c = res.num_matches, res.num_cmps
            brow_g = (brow_l if n_keys is not None
                      else _map_rows(bpay["row"], brow_l, ovalid))
            out.add(prow_g, brow_g, ovalid, total)
            counts += torch.stack([m.to(I64), c.to(I64), total.to(I64)])
            if not last:  # the chunk moves on to the ring neighbour
                if prefetch:
                    wk.wait()
                    wr.wait()
                    vkeys, vrow = nkeys, nrow
                else:
                    vkeys = ring_forward(vkeys, group, ns, index)[0]
                    vrow = ring_forward(vrow, group, ns, index)[0]
        probe_row, build_row, out_valid, dropped = out.finish()
        nm, nc, nu, ovf = _reduce([group], [*counts, bovf + dropped])
        return dict(num_matches=nm, num_cmps=nc, num_unnested=nu,
                    overflow=ovf, probe_row=probe_row, build_row=build_row,
                    out_valid=out_valid)

    return step
