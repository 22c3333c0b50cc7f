"""One-call join API: the front door over the tables and the probe strands.

Port of ``hashjoin3d_tpu/api.py`` (``JoinResult``, ``join``,
``_join_with_mode``, ``_join_with_predicate``,
``_join_with_predicate_inchain``), for users who want the reference's end
result, joined row-id pairs and the plan counters, without wiring build,
probe and expansion by hand:

    import hashjoin3d_tpu_torch as hj
    res = hj.join(build_keys, probe_keys)             # 3D table, on CUDA
    res.probe_rows, res.build_rows                     # numpy int32 arrays
    res.num_matches, res.num_cmps, res.num_results

Inputs are host key columns (numpy, or anything ``np.asarray`` takes) of
any integer width: u32 and narrower keys ride the int32 carrier, 8-byte and
composite (:func:`~.ops.layout.pack2u32`) keys the int64 one.  When either
side is 64-bit both columns widen to u64 (a narrower column zero-extends
from its u32 bits) before the build, so build and probe hash with one
functor width, as the reference's single key type would.

The physical plan is the JAX package's (``api.py:223-320``): permutation
u32 build keys take the dense-direct chaining layout and its one-pass
strand; u32 keys in a dense domain take the ``key_direct`` strands; every
other key (u64, composite, signed, sparse u32) takes the merged strands.
Each of the last two makes one sizing pass whose counters are read back,
then the materialising pass into a buffer of exactly that size.

``device`` (default ``"cuda"``) places the device path's work: on CUDA
every kernel of the path launches (or raises), on ``"cpu"`` the plain
versions run; asking for CUDA on a host without it raises.  ``backend``
(default ``"device"``) picks the path: ``"host"`` runs the native C++
engine (``hostengine.py``: the same counters, registry functors only),
``"auto"`` sends a query of fewer than :data:`HOST_CROSSOVER_ROWS` build
plus probe rows to the host engine and the rest to the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .hostengine import HASHFUN_IDS, host_chaining_join, host_nested_join
from .ops.chaining import (build_chaining_host, can_use_dense_direct,
                           probe_chaining)
from .ops.layout import key_column, resolve_device, widen_u64
from .ops.nested import build_nested_host, probe_nested
from .ops.predicate import chaining_inchain_probe, nested_inchain_probe
from .ops.strands_windowed import (direct_probe_strand_sorted,
                                   keydirect_chaining_strand_sorted,
                                   keydirect_nested_strand_sorted,
                                   merged_chaining_strand_sorted,
                                   merged_nested_strand_sorted)


@dataclass(frozen=True)
class JoinResult:
    """Materialised join: global row-id pairs and the reference's counters.
    ``route_worst`` is the worst windowed-lookup route of the strands that
    ran (0 windowed, 1 patched, 2 gather; 0 where no strand ran) and
    ``route_nbad`` the most uncovered chunks one of their lookups saw."""

    probe_rows: np.ndarray   # i32[num_results]
    build_rows: np.ndarray   # i32[num_results]
    num_matches: int         # probe-op _count (c_htProbe)
    num_cmps: int            # chain comparisons (c_htProbeCmp)
    num_results: int         # emitted tuples (c_top; the unnest count for 3D)
    route_worst: int = 0
    route_nbad: int = 0

    def pairs(self):
        return list(zip(self.probe_rows.tolist(), self.build_rows.tolist()))

    def take(self, probe_cols: dict | None = None,
             build_cols: dict | None = None) -> dict:
        """Gather payload columns through the row-id pairs.  Build rows of
        -1 (left, semi and anti modes) yield the column dtype's zero."""
        out = {}
        for name, col in (probe_cols or {}).items():
            out[name] = np.asarray(col)[self.probe_rows]
        for name, col in (build_cols or {}).items():
            col = np.asarray(col)
            if col.size == 0:  # every build row is -1 (empty build side)
                out[name] = np.zeros(self.build_rows.size, col.dtype)
                continue
            safe = np.where(self.build_rows >= 0, self.build_rows, 0)
            out[name] = np.where(self.build_rows >= 0, col[safe],
                                 np.zeros((), col.dtype))
        return out


#: ``backend="auto"``'s crossover: below this many build plus probe rows
#: the host engine answers a ``join`` call before the device path does.
#: ``chip_smoke.py`` phase 10c on an NVIDIA H100 80GB HBM3 at 700 W
#: (nested joins, R:S 1:16, median of 3 calls): three runs put the
#: smallest size from which the device won at every larger one at
#: 278,528, 1,114,112 and 557,056 rows; this is their median.  At 557,056
#: the engine took 27.8 ms against the device's 14.9 (the 2x sweep), at
#: 278,528 9.5 / 6.8 / 10.9 ms against 7.8 / 9.0 / 15.3.
HOST_CROSSOVER_ROWS = 557_056


def join(build_keys, probe_keys, how: str = "nested",
         num_buckets: int | None = None, unique: bool = False,
         n_keys: int | None = None, key_domain: int | None = None,
         backend: str = "device", mode: str = "inner",
         hashfun="murmur", predicate=None, predicate_mode: str = "post",
         probe_payload: dict | None = None,
         build_payload: dict | None = None,
         device="cuda") -> JoinResult:
    """Equi-join ``probe_keys`` against ``build_keys``; returns row-id pairs.

    ``how``: "nested" (the 3D table, ``ht_nested.hh``) or "chaining"
    (``ht_chaining.hh``).  ``unique`` is the chaining plan's
    IsBuildKeyUnique early exit.  ``num_buckets`` defaults to the
    distinct-key count.  ``n_keys`` / ``key_domain`` are the optional build
    hints (``build_*_host``).  ``backend``: "device" (default), "host"
    (the native engine, u32 or u64 keys, registry functors) or "auto"
    (the host engine below :data:`HOST_CROSSOVER_ROWS` build plus probe
    rows with a registry functor, else the device).

    ``mode``: "inner" (default); "left" adds (probe_row, -1) for matchless
    probe rows; "semi" the probe rows with a match and "anti" those
    without, build rows -1.  num_matches / num_cmps describe the
    underlying probe.

    ``hashfun``: a ``ops.hashing.HASH_FUNCTORS`` name ("murmur", "boncz",
    "fib", "mult", "identity") or a callable, carrier in and same-width
    carrier out (``ht_chaining.hh:236-248``).

    ``predicate(probe_cols, build_cols) -> bool array`` adds a join
    predicate over the candidate pairs' payload columns (``probe_payload``
    / ``build_payload``; the join keys under ``"key"``).
    ``predicate_mode="post"`` filters the equality matches (num_cmps stays
    the equality probe's); ``"inchain"`` evaluates it inside the chain
    walk, reference-exact (``ops/predicate.py``, on the host).

    ``device``: "cuda" (default) or "cpu" (the plain versions), for the
    device path.
    """
    if how not in ("nested", "chaining"):
        raise ValueError(f"how must be 'nested' or 'chaining', got {how!r}")
    if backend not in ("device", "host", "auto"):
        raise ValueError(
            f"backend must be 'device', 'host' or 'auto', got {backend!r}")
    if mode not in ("inner", "left", "semi", "anti"):
        raise ValueError(f"unknown mode {mode!r}")
    if callable(hashfun) and backend == "host":
        raise ValueError(
            "backend='host' supports registry hash functors only "
            "(callables cannot cross the C ABI); use backend='device'")

    bk = np.ascontiguousarray(build_keys)
    pk = np.ascontiguousarray(probe_keys)

    if predicate is not None:
        if predicate_mode not in ("post", "inchain"):
            raise ValueError(
                f"predicate_mode must be 'post' or 'inchain', "
                f"got {predicate_mode!r}")
        if predicate_mode == "inchain":
            return _join_with_predicate_inchain(
                bk, pk, how, num_buckets, unique, n_keys, mode, hashfun,
                predicate, probe_payload or {}, build_payload or {})
        return _join_with_predicate(
            bk, pk, how, num_buckets, unique, n_keys, key_domain, backend,
            mode, hashfun, predicate, probe_payload or {},
            build_payload or {}, device)

    if backend == "auto":
        small = bk.size + pk.size < HOST_CROSSOVER_ROWS
        backend = ("host" if small and isinstance(hashfun, str)
                   and hashfun in HASHFUN_IDS else "device")
    empty = _empty(bk, pk, mode)
    if empty is not None:
        return empty
    if backend == "host":
        return _host_join(bk, pk, how, num_buckets, unique, n_keys, mode,
                          hashfun)
    dev = resolve_device(device)
    bt, pt = _carriers(bk, pk, dev)
    # counters are bucket-dependent: explicit num_buckets > the n_keys hint
    # > the exact distinct count (counted on the device: a host np.unique
    # of a large column costs more than the whole join's device work)
    if num_buckets is None:
        num_buckets = max(1, n_keys if n_keys is not None
                          else int(torch.unique(bt).numel()))
    if mode != "inner":
        return _join_with_mode(bk, pk, bt, pt, how, num_buckets, unique,
                               n_keys, key_domain, mode, hashfun)
    return _device_join(bk, pk, bt, pt, how, num_buckets, unique, n_keys,
                        key_domain, hashfun)


def _empty(bk, pk, mode) -> JoinResult | None:
    """The result of a join with an empty side (the strands take non-empty
    columns), or None."""
    if bk.size and pk.size:
        return None
    if mode in ("left", "anti") and pk.size:
        rows = np.arange(pk.size, dtype=np.int32)
        return JoinResult(rows, np.full(pk.size, -1, np.int32), 0, 0, pk.size)
    empty = np.zeros(0, np.int32)
    return JoinResult(empty, empty, 0, 0, 0)


def _carriers(bk: np.ndarray, pk: np.ndarray, dev):
    """Both key columns on ``dev``; when either is 64-bit, both as int64
    (a narrower column zero-extended from its u32 bits)."""
    bt, pt = key_column(bk, dev), key_column(pk, dev)
    if bk.dtype.itemsize == 8 or pk.dtype.itemsize == 8:
        bt, pt = widen_u64(bt), widen_u64(pt)
    return bt, pt


def _result(out: dict, num_matches, num_cmps, num_results,
            pre: dict | None = None) -> JoinResult:
    """A strand's hit pairs on the host (one copy each) as a JoinResult;
    the routes are the worst of ``out`` and the sizing pass ``pre``."""
    v = out["probe_row"] >= 0
    routes = (out, pre) if pre is not None else (out,)
    return JoinResult(out["probe_row"][v].cpu().numpy(),
                      out["build_row"][v].cpu().numpy(), int(num_matches),
                      int(num_cmps), int(num_results),
                      max(r["route_worst"] for r in routes),
                      max(r["route_nbad"] for r in routes))


def device_route(bk, pk, num_buckets, key_domain, hashfun) -> tuple:
    """``(narrow, dense, key_domain)``: how :func:`_device_join` routes
    the host columns ``bk``, ``pk``.  ``narrow``: both are 32-bit
    unsigned; ``key_domain``: the given one or, on narrow columns, the
    build's largest key + 1 where that is at most 4 keys a row;
    ``dense``: the dense-direct chaining table takes the build."""
    # key_direct inference wants 32-bit UNSIGNED keys on both sides: signed
    # columns carry negatives as huge u32 values, and a u64 key would not
    # fit the u32 index
    narrow = (bk.dtype.kind == "u" and bk.dtype.itemsize == 4
              and pk.dtype.kind == "u" and pk.dtype.itemsize == 4)
    if key_domain is None and narrow:
        dom = int(bk.max()) + 1
        if dom <= 4 * bk.size:  # a sparser index wastes memory for few hits
            key_domain = dom
    dense = narrow and can_use_dense_direct(bk, num_buckets, hashfun)
    return narrow, dense, key_domain


def _device_join(bk, pk, bt, pt, how, num_buckets, unique, n_keys,
                 key_domain, hashfun) -> JoinResult:
    """The inner join's device path over the host columns ``bk``, ``pk``
    and their carriers ``bt``, ``pt``: dense-direct, key_direct or merged
    (``api.py:223-320`` of the JAX package)."""
    narrow, dense, key_domain = device_route(bk, pk, num_buckets,
                                             key_domain, hashfun)

    if how == "chaining" and dense:
        table = build_chaining_host(bt, num_buckets, dense_direct=True,
                                    n_keys=bk.size,
                                    full_chain_index=not unique,
                                    hashfun=hashfun)
        out = direct_probe_strand_sorted(table, pt, unique=unique)
        return _result(out, out["c_htProbe"], out["c_htProbeCmp"],
                       out["total"])

    if how == "chaining":
        table = build_chaining_host(bt, num_buckets, n_keys=n_keys,
                                    key_domain=key_domain, hashfun=hashfun)
        if table.key_direct is not None and narrow:
            strand = keydirect_chaining_strand_sorted
            pre = strand(table, pt, 1, unique=unique)
        else:
            strand = merged_chaining_strand_sorted
            pre = strand(table, pt, 1, unique=unique, do_expand=False)
        # the emitted-pair total of a chaining probe is its match count
        m, c = int(pre["c_htProbe"]), int(pre["c_htProbeCmp"])
        out = strand(table, pt, max(1, m), unique=unique)
        return _result(out, m, c, m, pre)

    table = build_nested_host(bt, num_buckets, n_keys=n_keys,
                              key_domain=key_domain, hashfun=hashfun)
    if table.key_direct is not None and narrow:
        strand = keydirect_nested_strand_sorted
    else:
        strand = merged_nested_strand_sorted
    pre = strand(table, pt, 1, do_unnest=False)
    m, c, total = (int(pre[k]) for k in ("c_htProbe", "c_htProbeCmp",
                                         "c_expand_total"))
    out = strand(table, pt, max(1, total))
    return _result(out, m, c, total, pre)


def _host_join(bk, pk, how, num_buckets, unique, n_keys, mode,
               hashfun) -> JoinResult:
    """The host engine's join (``api.py:206-216`` of the JAX package):
    u32 and u64 keys take the engine's width-matched instantiation; left,
    semi and anti derive from the inner pairs."""
    if num_buckets is None:
        num_buckets = max(1, n_keys if n_keys is not None
                          else int(np.unique(bk).size))
    if how == "chaining":
        prow, brow, m, c = host_chaining_join(bk, pk, num_buckets,
                                              unique=unique, hashfun=hashfun)
        total = prow.size
    else:
        prow, brow, m, c, total = host_nested_join(bk, pk, num_buckets,
                                                   hashfun=hashfun)
    return _derive(mode, pk.shape[0], prow, brow, m, c, total)


def _rows_where(hit: np.ndarray) -> np.ndarray:
    return np.nonzero(hit)[0].astype(np.int32)


def _derive(mode, P, prow, brow, m, c, total, route=(0, 0)) -> JoinResult:
    """left / semi / anti from the surviving inner pairs (``prow``,
    ``brow``) of ``P`` probe rows; ``route`` is the inner join's
    (``route_worst``, ``route_nbad``)."""
    if mode == "inner":
        return JoinResult(prow, brow, m, c, total, *route)
    hit = np.zeros(P, bool)
    hit[prow] = True
    if mode == "left":
        miss = _rows_where(~hit)
        return JoinResult(np.concatenate([prow, miss]),
                          np.concatenate([brow, np.full(miss.size, -1,
                                                        np.int32)]),
                          m, c, total + miss.size, *route)
    rows = _rows_where(hit if mode == "semi" else ~hit)
    return JoinResult(rows, np.full(rows.size, -1, np.int32), m, c,
                      rows.size, *route)


def _join_with_mode(bk, pk, bt, pt, how, num_buckets, unique, n_keys,
                    key_domain, mode, hashfun) -> JoinResult:
    """left / semi / anti, from the inner probe's hit set.  semi and anti
    never materialise the inner pairs: ``probe_chaining`` /
    ``probe_nested`` give the per-row hit mask."""
    if mode in ("semi", "anti"):
        if how == "chaining":
            table = build_chaining_host(bt, num_buckets, n_keys=n_keys,
                                        key_domain=key_domain,
                                        hashfun=hashfun)
            res = probe_chaining(table, pt, unique=unique)
        else:
            table = build_nested_host(bt, num_buckets, n_keys=n_keys,
                                      key_domain=key_domain, hashfun=hashfun)
            res = probe_nested(table, pt)
        hit = res.hit.cpu().numpy()
        rows = _rows_where(hit if mode == "semi" else ~hit)
        return JoinResult(rows, np.full(rows.size, -1, np.int32),
                          int(res.num_matches), int(res.num_cmps), rows.size)

    inner = _device_join(bk, pk, bt, pt, how, num_buckets, unique, n_keys,
                         key_domain, hashfun)
    return _derive(mode, pk.shape[0], inner.probe_rows, inner.build_rows,
                   inner.num_matches, inner.num_cmps, inner.num_results,
                   (inner.route_worst, inner.route_nbad))


def _check_keep(keep, shape) -> np.ndarray:
    keep = np.asarray(keep, bool)
    if keep.shape != shape:
        raise ValueError(f"predicate returned shape {keep.shape}, expected "
                         f"{shape}")
    return keep


def _join_with_predicate(bk, pk, how, num_buckets, unique, n_keys,
                         key_domain, backend, mode, hashfun, predicate,
                         probe_payload, build_payload, dev) -> JoinResult:
    """Residual predicate, ``predicate_mode="post"``: the equality pairs are
    materialised, the predicate runs once over their columns, and left /
    semi / anti derive from the surviving matches (``concepts.hh:49-56``,
    ``algebra.hh:647-648``)."""
    inner = join(bk, pk, how=how, num_buckets=num_buckets, unique=unique,
                 n_keys=n_keys, key_domain=key_domain, backend=backend,
                 hashfun=hashfun, device=dev)
    pcols = {n: np.asarray(c)[inner.probe_rows]
             for n, c in probe_payload.items()}
    bcols = {n: np.asarray(c)[inner.build_rows]
             for n, c in build_payload.items()}
    pcols.setdefault("key", pk[inner.probe_rows])
    bcols.setdefault("key", bk[inner.build_rows])
    keep = _check_keep(predicate(pcols, bcols), inner.probe_rows.shape)
    prow, brow = inner.probe_rows[keep], inner.build_rows[keep]
    return _derive(mode, pk.shape[0], prow, brow, prow.size, inner.num_cmps,
                   prow.size, (inner.route_worst, inner.route_nbad))


def _join_with_predicate_inchain(bk, pk, how, num_buckets, unique, n_keys,
                                 mode, hashfun, predicate, probe_payload,
                                 build_payload) -> JoinResult:
    """Reference-exact in-chain predicate join (``algebra.hh:625-659``,
    ``ht_nested.hh:354-382``): the counters reflect the predicate evaluated
    inside the chain walk, simulated on the host (``ops/predicate.py``);
    left / semi / anti derive from the surviving matches."""
    if not isinstance(hashfun, str):
        raise ValueError(
            "predicate_mode='inchain' needs a registry hash functor name "
            "(the host-side walk uses the numpy functor mirrors)")
    empty = _empty(bk, pk, mode)
    if empty is not None:
        return empty
    if num_buckets is None:
        num_buckets = max(1, n_keys if n_keys is not None
                          else int(np.unique(bk).size))

    def evaluate(p_idx, b_rows):
        pcols = {n: np.asarray(c)[p_idx] for n, c in probe_payload.items()}
        bcols = {n: np.asarray(c)[b_rows] for n, c in build_payload.items()}
        pcols.setdefault("key", pk[p_idx])
        bcols.setdefault("key", bk[b_rows])
        return _check_keep(predicate(pcols, bcols), p_idx.shape)

    if how == "chaining":
        prow, brow, m, c = chaining_inchain_probe(
            bk, pk, num_buckets, unique, evaluate, hashfun)
        total = prow.size
    else:
        prow, brow, m, c, total = nested_inchain_probe(
            bk, pk, num_buckets, evaluate, hashfun)
    return _derive(mode, pk.shape[0], prow, brow, m, c, total)


__all__ = ["JoinResult", "join"]
