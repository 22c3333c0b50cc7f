"""A whole distributed query: filter -> 3D hash join -> hash aggregate.

Port of ``hashjoin3d_tpu/parallel/pipeline.py``.  Per shard: filter the
probe columns (before the exchange: filtered rows never move), exchange
both sides by join key, build and probe the local 3D table, unnest, and
aggregate the joined build values by key.  The exchange partitions the
groups by key, so each shard's aggregates are already global: no second
exchange.
"""

from __future__ import annotations

import torch

from ..ops.aggregate import hash_aggregate
from ..ops.layout import I64
from ..ops.nested import build_nested, probe_nested, unnest
from .dist_join import _check_columns, _reduce
from .mesh import SHARD_AXIS, axis_info
from .shuffle import partition_exchange


def dist_filter_join_aggregate(mesh, num_buckets_per_shard: int,
                               build_capacity: int, probe_capacity: int,
                               out_capacity: int, predicate,
                               axis: str = SHARD_AXIS):
    """A distributed filter -> join -> aggregate step.

    ``step(build_keys, build_vals, probe_keys, probe_payload) -> dict``,
    each rank with its block of each column.  ``predicate(payload)``
    (a tensor in, a bool tensor out) keeps probe rows before the
    exchange.  Returns the global ``num_filtered``, ``num_matches``,
    ``num_joined``, ``sum_v`` (of the joined build values), ``overflow``
    and ``n_groups``, and this shard's per-key ``group_keys``,
    ``group_count`` and ``group_sum`` (slots with count 0 are padding).
    Keys keep their width (u64 groups stay distinct)."""
    group, ns, _ = axis_info(mesh, axis)

    def step(build_keys, build_vals, probe_keys, probe_payload):
        _check_columns(build_keys, probe_keys)
        keep = predicate(probe_payload)
        bkeys, bpay, bvalid, bovf = partition_exchange(
            group, build_keys, {"val": build_vals}, ns, build_capacity,
            reduce_overflow=False)
        table = build_nested(bkeys, num_buckets_per_shard, valid=bvalid)
        pkeys, _, pvalid, povf = partition_exchange(
            group, probe_keys, {}, ns, probe_capacity, valid=keep,
            reduce_overflow=False)
        res = probe_nested(table, pkeys, mask=pvalid)
        prow_l, brow_l, ovalid, total = unnest(table, res, out_capacity)

        # groups by join key, which the exchange partitioned
        jkeys = torch.where(ovalid,
                            pkeys[torch.clamp(prow_l, min=0).long()], 0)
        jvals = torch.where(ovalid,
                            bpay["val"][torch.clamp(brow_l, min=0).long()],
                            0)
        agg = hash_aggregate(jkeys, {"v": jvals}, mask=ovalid)
        nf, nm, nj, sv, ovf, ng = _reduce([group], [
            keep.sum(dtype=I64), res.num_matches, total,
            jvals.to(I64).sum(), bovf + povf, agg.n_keys.to(I64)])
        return dict(num_filtered=nf, num_matches=nm, num_joined=nj,
                    sum_v=sv, overflow=ovf, group_keys=agg.keys,
                    group_count=agg.count, group_sum=agg.sums["v"],
                    n_groups=ng)

    return step
