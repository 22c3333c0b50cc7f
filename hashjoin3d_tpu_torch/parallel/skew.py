"""Skew handling for distributed joins: detection, the broadcast join and
the hybrid join.

Port of ``hashjoin3d_tpu/parallel/skew.py``.  A zipf-skewed key column
routes a large share of its rows to one shard and overflows that shard's
exchange capacity.  :func:`detect_skew` is the host-side heavy-hitter
report (numpy); :func:`dist_broadcast_join` replicates the build side to
every shard (``all_gather_into_tensor``) and probes locally, so probe
skew cannot imbalance an exchange; :func:`dist_hybrid_nested_join`
replicates only the hot keys' build rows and partitions the rest.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.chaining import (build_chaining, materialize_chaining_join,
                            probe_chaining)
from ..ops.hashing import murmur32_np, murmur64_np
from ..ops.layout import I32, I64, key_column
from ..ops.nested import build_nested, probe_nested, unnest
from .dist_join import _check_columns, _global_rows, _map_rows, _reduce
from .mesh import SHARD_AXIS, axis_info
from .shuffle import partition_exchange


def detect_skew(keys, num_shards: int, sample: int = 1 << 20, seed: int = 0,
                max_hot: int = 16):
    """Host-side skew report of a key column (sampled past ``sample``
    rows): the top key's frequency, the max/mean shard load under hash
    partitioning, a strategy ("partition", "hybrid" or "broadcast"),
    ``hot_keys`` (up to ``max_hot`` keys each above 1/num_shards of the
    sample: the keys the hybrid join replicates) and ``top_keys`` (the
    ``max_hot`` most frequent keys, whatever their share: under exp-1's
    zipf(1.0) no key passes the mean share on a small mesh, yet the head
    still overflows a uniformly sized exchange)."""
    keys = np.asarray(keys)
    n = keys.size
    if n > sample:
        ks = keys[np.random.default_rng(seed).integers(0, n, sample)]
    else:
        ks = keys
    uniq, counts = np.unique(ks, return_counts=True)
    top_frac = counts.max() / ks.size

    hot_mask = counts * num_shards > ks.size
    n_hot = int(np.count_nonzero(hot_mask))  # before the max_hot cut
    order = np.argsort(counts[hot_mask])[::-1][:max_hot]
    hot_keys = uniq[hot_mask][order]
    top_keys = uniq[np.argsort(counts)[::-1][:max_hot]]

    # the host mirror of shard_of_key, width-matched
    if ks.dtype.itemsize == 8:
        shard = murmur64_np(murmur64_np(ks)) % np.uint64(num_shards)
    else:
        shard = murmur32_np(murmur32_np(ks)) % np.uint32(num_shards)
    loads = np.bincount(shard.astype(np.int64), minlength=num_shards)
    imbalance = loads.max() / max(loads.mean(), 1)

    if top_frac * num_shards <= 1.0:
        strategy = "partition"
    elif n_hot <= max_hot and top_frac < 0.9:
        # hybrid only if the replicated set covers every hot key
        strategy = "hybrid"
    else:
        strategy = "broadcast"
    return dict(top_key_fraction=float(top_frac),
                shard_imbalance=float(imbalance), strategy=strategy,
                hot_keys=hot_keys, top_keys=top_keys)


def suggest_capacity(n_local: int, num_shards: int, imbalance: float,
                     slack: float = 1.25) -> int:
    """Exchange capacity per (source, destination) pair covering the
    measured imbalance."""
    per_dst = n_local / num_shards
    return int(per_dst * max(imbalance, 1.0) * slack) + 64


def _all_gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated in rank order."""
    out = torch.empty((size * x.shape[0],), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def dist_broadcast_join(mesh, num_buckets: int, out_capacity: int,
                        nested: bool = True, unique: bool = False,
                        axis: str = SHARD_AXIS):
    """Broadcast-build distributed join: the build side gathered onto
    every shard in global order, probes local.

    ``step(build_keys, probe_keys)``: each shard builds the whole table
    and probes its own rows, so no probe moves and probe skew is
    irrelevant.  Counters summed over the mesh (``num_unnested`` for the
    3D table, ``num_results`` for chaining, with ``unique``); pairs in
    global row ids (the gather keeps the global build order)."""
    group, ns, index = axis_info(mesh, axis)

    def step(build_keys, probe_keys):
        _check_columns(build_keys, probe_keys)
        np_local = probe_keys.shape[0]
        all_build = _all_gather(build_keys, group, ns)
        probe_gids = _global_rows(np_local, index, probe_keys.device)
        if nested:
            table = build_nested(all_build, num_buckets)
            res = probe_nested(table, probe_keys)
            prow_l, brow_l, ovalid, total = unnest(table, res, out_capacity)
            name = "num_unnested"
        else:
            table = build_chaining(all_build, num_buckets,
                                   early_exit_index=unique)
            res = probe_chaining(table, probe_keys, unique=unique)
            prow_l, brow_l, ovalid, total = materialize_chaining_join(
                table, res, out_capacity, unique=unique)
            name = "num_results"
        nm, nc, nt = _reduce([group], [res.num_matches, res.num_cmps,
                                       total])
        return {"num_matches": nm, "num_cmps": nc, name: nt,
                "probe_row": _map_rows(probe_gids, prow_l, ovalid),
                "build_row": torch.where(ovalid, brow_l, -1),
                "out_valid": ovalid}

    return step


def _hot_column(hot_keys, like: torch.Tensor) -> torch.Tensor:
    """The hot keys as ``like``'s key carrier on its device."""
    vals = np.asarray([int(k) for k in hot_keys], dtype=np.uint64)
    if like.dtype != I64:
        vals = vals.astype(np.uint32)
    return key_column(vals, like.device)


def _is_hot(keys: torch.Tensor, hot: torch.Tensor) -> torch.Tensor:
    """Membership of each key in a small hot-key column."""
    return torch.isin(keys, hot)


def dist_hybrid_nested_join(mesh, hot_keys, num_buckets_per_shard: int,
                            build_capacity: int, probe_capacity: int,
                            hot_build_capacity: int, out_capacity: int,
                            axis: str = SHARD_AXIS):
    """Hybrid skew strategy: replicate the HOT keys' build rows, partition
    the rest.

    Build rows whose key is in ``hot_keys`` (a small host-side set, from
    :func:`detect_skew`) are gathered onto every shard (at most
    ``hot_build_capacity`` a rank; more is overflow), which builds a
    replicated hot 3D table; the cold rows take the normal exchange into
    per-shard cold tables.  Hot probes never move and probe the local
    replica; cold probes are exchanged.  No capacity depends on the hot
    keys' frequency.  Counters summed over the mesh; each shard's pairs
    are its hot pairs, then its cold pairs (``2 * out_capacity`` slots),
    in global row ids.
    """
    group, ns, index = axis_info(mesh, axis)
    n_hot_keys = len(hot_keys)

    def step(build_keys, probe_keys):
        _check_columns(build_keys, probe_keys)
        dev = build_keys.device
        nb_local = build_keys.shape[0]
        brow_g = _global_rows(nb_local, index, dev)
        prow_g = _global_rows(probe_keys.shape[0], index, dev)
        hot = _hot_column(hot_keys, build_keys)
        bhot = _is_hot(build_keys, hot)
        phot = _is_hot(probe_keys, hot)

        # hot side: pack the local hot rows, gather them, build a replica
        hpos = torch.cumsum(bhot.to(I32), 0, dtype=I32) - 1
        i = torch.arange(nb_local, dtype=I32, device=dev)
        tgt = torch.where(bhot & (hpos < hot_build_capacity), hpos,
                          hot_build_capacity + i).long()
        hkeys = torch.zeros(hot_build_capacity + nb_local,
                            dtype=build_keys.dtype, device=dev)
        hrows = torch.full((hot_build_capacity + nb_local,), -1, dtype=I32,
                           device=dev)
        hkeys[tgt] = build_keys
        hrows[tgt] = brow_g
        n_hot = bhot.sum(dtype=I64)
        hvalid = (torch.arange(hot_build_capacity, dtype=I64, device=dev)
                  < n_hot)
        hot_ovf = torch.clamp(n_hot - hot_build_capacity, min=0)
        all_hkeys = _all_gather(hkeys[:hot_build_capacity], group, ns)
        all_hrows = _all_gather(hrows[:hot_build_capacity], group, ns)
        all_hvalid = _all_gather(hvalid.to(I32), group, ns) > 0
        hot_table = build_nested(all_hkeys, max(n_hot_keys, 1),
                                 valid=all_hvalid)

        # cold side: the normal partitioned join
        ckeys, cpay, cvalid, covf = partition_exchange(
            group, build_keys, {"row": brow_g}, ns, build_capacity,
            valid=~bhot, reduce_overflow=False)
        cold_table = build_nested(ckeys, num_buckets_per_shard, valid=cvalid)
        pkeys_c, ppay_c, pvalid_c, povf = partition_exchange(
            group, probe_keys, {"row": prow_g}, ns, probe_capacity,
            valid=~phot, reduce_overflow=False)

        hres = probe_nested(hot_table, probe_keys, mask=phot)
        hp, hb, hv, htot = unnest(hot_table, hres, out_capacity)
        cres = probe_nested(cold_table, pkeys_c, mask=pvalid_c)
        cp, cb, cv, ctot = unnest(cold_table, cres, out_capacity)
        out_ovf = (torch.clamp(htot - out_capacity, min=0)
                   + torch.clamp(ctot - out_capacity, min=0))

        nm, nc, nu, ovf = _reduce([group], [
            hres.num_matches + cres.num_matches,
            hres.num_cmps + cres.num_cmps, htot + ctot,
            hot_ovf + covf + povf + out_ovf])
        return dict(
            num_matches=nm, num_cmps=nc, num_unnested=nu, overflow=ovf,
            probe_row=torch.cat([_map_rows(prow_g, hp, hv),
                                 _map_rows(ppay_c["row"], cp, cv)]),
            build_row=torch.cat([_map_rows(all_hrows, hb, hv),
                                 _map_rows(cpay["row"], cb, cv)]),
            out_valid=torch.cat([hv, cv]))

    return step
