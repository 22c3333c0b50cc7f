"""Hierarchical (host x chip) distribution: a 2-D mesh and a two-hop
exchange.

Port of ``hashjoin3d_tpu/parallel/hier.py``.  Across hosts, links are
asymmetric (NVLink or ICI inside a host, the network between hosts), so
each row first moves to the right *chip column* inside its own host, then
between hosts within that column, in one aggregated message per host
pair.  A key's global shard is ``shard_of_key(k, H * C)``, owned by host
``d // C``, chip ``d % C``; after both hops every row sits where the flat
exchange would put it, in the same arrival order (source rank by source
rank), so the shard-local build and probe are the flat join's.

``make_mesh_2d`` is a 2-D ``DeviceMesh`` named ``("host", "chip")``; its
two axis groups carry the hops.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..ops.layout import I32, check_carrier
from ..ops.sort import window_for_chunk
from .dist_join import (_check_columns, _map_rows, _nested_table,
                        _probe_nested_route, _reduce)
from .mesh import _backend_device, axis_info
from .shuffle import all_to_all, pack_by_dest, shard_of_key

HOST_AXIS, CHIP_AXIS = "host", "chip"


def make_mesh_2d(n_hosts: int, chips_per_host: int, device=None,
                 axes=(HOST_AXIS, CHIP_AXIS)) -> DeviceMesh:
    """A (host, chip) mesh over the first ``n_hosts * chips_per_host``
    ranks, rank ``h * chips_per_host + c`` at (h, c), on ``device``
    ("cuda" by default; a 1-rank group is started when none exists, as
    :func:`~.mesh.make_mesh` does)."""
    dev = _backend_device(device)
    n = n_hosts * chips_per_host
    if n > dist.get_world_size():
        raise ValueError(f"requested {n} devices, have "
                         f"{dist.get_world_size()}")
    return init_device_mesh(dev.type, (n_hosts, chips_per_host),
                            mesh_dim_names=tuple(axes))


def _exchange_1hop(group, dest: torch.Tensor, cols: list, num_groups: int,
                   capacity: int, valid: torch.Tensor,
                   sort_by_key_cols: int = 0):
    """Route rows to ``dest`` over one axis group (the scheme of
    ``shuffle.partition_exchange``, over a list of columns, validity
    aware).  ``sort_by_key_cols`` also orders rows within each
    destination by the first k columns compared as unsigned, so each
    receive block arrives ascending with its dead slots (all ones) at the
    tail.  Returns ``(received columns, valid, this rank's dropped
    rows)``, each receive ``num_groups * capacity`` long."""
    send, send_valid, dropped = pack_by_dest(
        dest, cols, [-1] * len(cols), num_groups, capacity, valid,
        sort_cols=sort_by_key_cols)
    recv, _ = all_to_all([*send, send_valid], group)
    return recv[:-1], recv[-1] > 0, dropped


def hier_exchange(mesh, keys: torch.Tensor, payload_rows: torch.Tensor,
                  capacity1: int, capacity2: int,
                  valid: torch.Tensor | None = None,
                  sort_within_dest: bool = False):
    """Two-hop exchange to each key's owning (host, chip).

    ``capacity1`` bounds the rows a (sender, chip column) pair takes in
    the intra-host hop, ``capacity2`` a (column holder, destination host)
    pair in the inter-host hop.  ``sort_within_dest`` key-orders the last
    hop's receive blocks (the presorted layout of the windowed strands).
    Returns ``(keys, rows, valid, overflow)``, the overflow this rank's
    dropped rows (the caller sums it with its counters)."""
    check_carrier(keys)
    chip_g, n_chips, _ = axis_info(mesh, CHIP_AXIS)
    host_g, n_hosts, _ = axis_info(mesh, HOST_AXIS)
    n = keys.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=keys.device)
    d = shard_of_key(keys, n_hosts * n_chips)
    chip_d = d % n_chips        # hop 1: chip column, inside the host
    host_d = d // n_chips       # hop 2: destination host
    (k1, rows1, hostd1), valid1, drop1 = _exchange_1hop(
        chip_g, chip_d, [keys, payload_rows.to(I32), host_d], n_chips,
        capacity1, valid)
    (k2, rows2), valid2, drop2 = _exchange_1hop(
        host_g, torch.clamp(hostd1, min=0), [k1, rows1], n_hosts,
        capacity2, valid1, sort_by_key_cols=1 if sort_within_dest else 0)
    return k2, rows2, valid2, drop1 + drop2


def dist_nested_join_2d(mesh, num_buckets_per_shard: int,
                        build_capacity: int, probe_capacity: int,
                        out_capacity: int, key_domain: int | None = None,
                        n_keys: int | None = None):
    """Distributed 3D join over a (host, chip) mesh with the two-hop
    exchange: the contract of :func:`~.dist_join.dist_nested_join`; the
    capacities are per hop and group (the inter-host hop takes twice the
    bound: a chip column gathers a whole host's rows for each host).
    ``key_domain`` probes the key-ordered last-hop receive presorted
    through the windowed strand, ``n_keys`` takes the fused compacted
    build with global build ids, as the flat join does."""
    _, n_chips, chip = axis_info(mesh, CHIP_AXIS)
    _, n_hosts, host = axis_info(mesh, HOST_AXIS)
    groups = [mesh.get_group(CHIP_AXIS), mesh.get_group(HOST_AXIS)]
    route = "default" if key_domain is None else "key_domain"

    def step(build_keys, probe_keys):
        _check_columns(build_keys, probe_keys)
        dev = build_keys.device

        def grows(n_local):
            base = (host * n_chips + chip) * n_local
            return base + torch.arange(n_local, dtype=I32, device=dev)

        bkeys, brows, bvalid, bovf = hier_exchange(
            mesh, build_keys, grows(build_keys.shape[0]), build_capacity,
            2 * build_capacity)
        table = _nested_table(bkeys, brows, bvalid, num_buckets_per_shard,
                              key_domain, n_keys)
        pkeys, prows, pvalid, povf = hier_exchange(
            mesh, probe_keys, grows(probe_keys.shape[0]), probe_capacity,
            2 * probe_capacity, sort_within_dest=key_domain is not None)
        # the receive: per-source sorted blocks of 2 * probe_capacity
        lookup_w = (window_for_chunk(2 * probe_capacity, key_domain)
                    if key_domain is not None else None)
        probe_row, brow, ovalid, total, n_matches, n_cmps = (
            _probe_nested_route(route, table, pkeys, prows, pvalid,
                                out_capacity, lookup_w))
        build_row = (torch.where(ovalid, brow, -1) if n_keys is not None
                     else _map_rows(brows, brow, ovalid))
        nm, nc, nu, ovf = _reduce(groups, [n_matches, n_cmps, total,
                                           bovf + povf])
        return dict(num_matches=nm, num_cmps=nc, num_unnested=nu,
                    overflow=ovf, probe_row=probe_row, build_row=build_row,
                    out_valid=ovalid)

    return step
