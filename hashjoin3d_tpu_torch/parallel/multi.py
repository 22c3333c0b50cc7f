"""Distributed two-join pipeline with deferred unnesting (exp-4,
distributed).

Port of ``hashjoin3d_tpu/parallel/multi.py``.  S.a and T.a join R on one
key, so one hash partitions S, T and R alike and every R row meets both
of its tables on one shard: one exchange a relation, then exp-4's Ndu
strand shard-locally (probe S, probe T under the S hits, unnest T then
S: ``main_experiment4.cc:832-941``), the nested tuples never crossing
the wire.
"""

from __future__ import annotations

import torch

from ..ops.nested import build_nested, deferred_two_join_strand
from .dist_join import _global_rows, _map_rows, _reduce
from .mesh import SHARD_AXIS, axis_info
from .shuffle import partition_exchange


def dist_deferred_two_join(mesh, num_buckets_per_shard: int,
                           fk_capacity: int, r_capacity: int,
                           out1_capacity: int, out2_capacity: int,
                           axis: str = SHARD_AXIS):
    """A distributed Ndu step: R |><| S |><| T, the unnests deferred.

    ``step(r_keys, s_keys, t_keys) -> dict``: the global counters
    (``c_probe_RS``, ``c_probe_RS_cmp``, ``c_probe_RT``,
    ``c_probe_RT_cmp``, ``c_unnest_1``, ``c_top``, ``overflow``) and this
    shard's ``(r_row, s_row, t_row)`` global-id triples with
    ``out_valid``.  ``fk_capacity`` bounds each FK side's exchange,
    ``r_capacity`` R's; ``out1_capacity`` the first (T) expansion and
    ``out2_capacity`` the result rows a shard, past which rows count as
    overflow."""
    group, ns, index = axis_info(mesh, axis)

    def step(r_keys, s_keys, t_keys):
        dev = r_keys.device

        def xchg(keys, cap):
            return partition_exchange(
                group, keys,
                {"row": _global_rows(keys.shape[0], index, dev)}, ns, cap,
                reduce_overflow=False)

        skeys, spay, svalid, sovf = xchg(s_keys, fk_capacity)
        tbl_s = build_nested(skeys, num_buckets_per_shard, valid=svalid)
        tkeys, tpay, tvalid, tovf = xchg(t_keys, fk_capacity)
        tbl_t = build_nested(tkeys, num_buckets_per_shard, valid=tvalid)
        rkeys, rpay, rvalid, rovf = xchg(r_keys, r_capacity)

        st = deferred_two_join_strand(tbl_s, tbl_t, rkeys, out1_capacity,
                                      out2_capacity, mask=rvalid)
        v2 = st["valid"]
        out_ovf = (torch.clamp(st["c_unnest_1"] - out1_capacity, min=0)
                   + torch.clamp(st["c_unnest_2"] - out2_capacity, min=0))
        red = _reduce([group], [
            st["c_probe_RS"], st["c_probe_RS_cmp"], st["c_probe_RT"],
            st["c_probe_RT_cmp"], st["c_unnest_1"], st["c_unnest_2"],
            sovf + tovf + rovf + out_ovf])
        names = ("c_probe_RS", "c_probe_RS_cmp", "c_probe_RT",
                 "c_probe_RT_cmp", "c_unnest_1", "c_top", "overflow")
        return dict(zip(names, red),
                    r_row=_map_rows(rpay["row"], st["r_row"], v2),
                    s_row=_map_rows(spay["row"], st["s_row"], v2),
                    t_row=_map_rows(tpay["row"], st["t_row"], v2),
                    out_valid=v2)

    return step
