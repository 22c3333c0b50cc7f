"""Out-of-core streaming run on one CUDA GPU: a probe column far larger
than any whole-column path of the engine holds, streamed from host memory
through a resident table.

Port of ``tools/oocbench.py``.  It

1. builds two tables on the card: a dense-direct chaining table over a
   permutation of 2^logr keys (exp-1's Csr shape, ``ht_chaining.hh:
   38-158``) and a nested (3D) table of 2^logb rows over the same 2^logr
   domain (``ht_nested.hh:71-251``), with its key_direct index;
2. draws 2^logp uniform probe keys on the host (2^27 of them are 512 MiB
   of u32; seed ``--seed``);
3. streams them through ``ops.streaming.stream_probe_chaining`` /
   ``stream_probe_nested`` in 2^logc-key chunks (pinned staging buffers, a
   side stream for the uploads, counters on the device), and
4. holds the streamed counters exactly against an independent numpy cost
   model of the reference's chain semantics (the tests hold the model
   against ``tests/oracle.py``).

Beside each stream it times the same chunks' copies alone (the host's copy
into pinned memory and the upload), their probes alone (the column
uploaded once, then probed chunk by chunk) and their sum
(``serial_ms``, what the stream would take with no overlap), the upload
rate on its own, and reads the kernels' launches (from 0) and the peak
device memory of the first streamed run; ``ms`` is a second, warm one.
One more streamed run under ``torch.profiler`` splits the
device's time: the union of the uploads' intervals (``copy_busy_ms``), of
every other device interval (``probe_busy_ms``), the time both run at once
(``overlap_ms``) and the share of the wall time the device is idle.

    python3 -m hashjoin3d_tpu_torch.tools.oocbench [--logp 27] [--logr 20]
        [--logb 24] [--logc 22] [--seed 20260817]

The card and its power limit print first; one JSON line a table follows.
Without a CUDA GPU it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops.chaining import build_chaining_host
from ..ops.hashing import murmur32_np
from ..ops.layout import I64, from_numpy_u32
from ..ops.nested import build_nested_host
from ..ops.streaming import (ChunkStager, chunk_probe_chaining,
                             chunk_probe_nested, stream_probe_chaining,
                             stream_probe_nested)
from ..utils.measure import card, require_cuda

def chaining_unique_cost(keys: np.ndarray, num_buckets: int) -> np.ndarray:
    """Per-key probe comparisons of a unique-key chaining table with early
    exit (``algebra.hh:653-655``), indexed by key (``keys`` a permutation
    of [0, len(keys))).  A bucket's chain is [first arrival, later
    arrivals LIFO] (``ht_chaining.hh:180-196``), so the k-th arrival (k >=
    2) of a bucket of c entries sits at position 1 + (c - k + 1)."""
    b = murmur32_np(keys) % np.uint32(num_buckets)
    order = np.argsort(b, kind="stable")
    bs = b[order]
    starts = np.flatnonzero(np.r_[True, bs[1:] != bs[:-1]])
    counts = np.diff(np.r_[starts, bs.size])
    arrival = np.arange(bs.size) - np.repeat(starts, counts)
    clen = np.repeat(counts, counts)
    cost = np.empty(keys.size, np.int64)
    cost[keys[order]] = np.where(arrival == 0, 1, 1 + (clen - arrival))
    return cost


def nested_cost_and_groups(bkeys: np.ndarray, num_buckets: int,
                           domain: int):
    """Per-key (comparisons, group size) of a nested table over [0,
    domain).  A bucket's main chain holds its distinct keys in first
    occurrence order (``ht_nested.hh:414-436``); a hit counts the main
    nodes up to and including its own, a miss the whole main chain
    (``ht_nested.hh:354-382``)."""
    uniq, first = np.unique(bkeys, return_index=True)
    ub = murmur32_np(uniq) % np.uint32(num_buckets)
    order = np.argsort(ub.astype(np.uint64) * np.uint64(bkeys.size) + first,
                       kind="stable")
    ubs = ub[order]
    starts = np.flatnonzero(np.r_[True, ubs[1:] != ubs[:-1]])
    counts = np.diff(np.r_[starts, ubs.size])
    cost = np.zeros(domain, np.int64)
    cost[uniq[order]] = np.arange(ubs.size) - np.repeat(starts, counts) + 1
    chain_len = np.zeros(num_buckets, np.int64)
    chain_len[ubs[starts]] = counts
    miss = np.ones(domain, bool)
    miss[uniq] = False
    missing = np.flatnonzero(miss).astype(np.uint32)
    cost[missing] = chain_len[murmur32_np(missing) % np.uint32(num_buckets)]
    gsize = np.bincount(bkeys, minlength=domain).astype(np.int64)
    return cost, gsize


def copy_only_ms(probes: np.ndarray, chunk: int, dev) -> tuple:
    """(wall ms, host-copy ms) of staging every chunk to the card with no
    probe: the host's copies into pinned memory and the side stream's
    uploads."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ChunkStager(probes, chunk, False, dev) as st:
        st.stage(0)
        for i in range(st.n_chunks):
            if i + 1 < st.n_chunks:
                st.stage(i + 1)
            st.take(i)
            st.release(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, st.host_s * 1e3


def h2d_gbps(chunk: int, dev, reps: int = 20) -> float:
    """Pinned host -> device rate of one chunk-sized copy, on events."""
    src = torch.empty(chunk, dtype=torch.int32, pin_memory=True)
    dst = torch.empty(chunk, dtype=torch.int32, device=dev)
    dst.copy_(src, non_blocking=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dst.copy_(src, non_blocking=True)
    end.record()
    torch.cuda.synchronize()
    return reps * chunk * 4 / (start.elapsed_time(end) * 1e-3) / 1e9


def probe_only_ms(probe_one, probes: np.ndarray, chunk: int, dev) -> float:
    """Wall ms of probing every chunk of a column already on the card."""
    col = from_numpy_u32(probes, dev)
    acc = torch.zeros(3, dtype=I64, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, col.shape[0], chunk):
        _, _, m, c, tot = probe_one(col[lo:lo + chunk])
        acc += torch.stack([m.to(I64), c.to(I64), tot.to(I64)])
    acc.tolist()
    ms = (time.perf_counter() - t0) * 1e3
    del col
    torch.cuda.empty_cache()
    return ms


def _union_ms(intervals) -> float:
    """Length of the union of ``(start, end)`` microsecond intervals, in
    ms."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total / 1e3


def profiled_split(fn) -> dict:
    """One run of ``fn`` under ``torch.profiler``: wall ms, the device's
    busy ms (union of its intervals), the uploads' and the probes' busy ms,
    the ms both run at once, and the idle share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in dev_events]
    copy = [(e.time_range.start, e.time_range.end) for e in dev_events
            if e.name.startswith("Memcpy HtoD")]
    probe = [(e.time_range.start, e.time_range.end) for e in dev_events
             if not e.name.startswith("Memcpy HtoD")]
    busy = _union_ms(spans)
    copy_ms, probe_ms = _union_ms(copy), _union_ms(probe)
    return dict(profiled_wall_ms=wall, busy_ms=busy, copy_busy_ms=copy_ms,
                probe_busy_ms=probe_ms, overlap_ms=copy_ms + probe_ms - busy,
                idle_share=1 - busy / wall, device_events=len(dev_events))


def _streamed(fn, dev) -> dict:
    """Run ``fn`` (one stream) with the launch counts and the peak memory
    from 0, then once more on the clock: the first run's result and
    launches, the second's wall ms, the peak bytes of both and the bytes
    resident when they began."""
    from .. import kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    kernels.reset_launch_counts()
    out = fn()
    launches = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    ms = (time.perf_counter() - t0) * 1e3
    return dict(out=out, ms=ms, launches=launches,
                peak_bytes=torch.cuda.max_memory_allocated(dev),
                resident_bytes=resident)


def run(dev, logp: int = 27, logr: int = 20, logb: int = 24, logc: int = 22,
        seed: int = 20260817, timings: bool = True) -> dict:
    """Both streams at 2^logp probes; each table's counters, the model's,
    wall ms, launches and peak memory, and (``timings``) the copy-only,
    probe-only and upload-rate readings.  Raises on a counter mismatch."""
    rng = np.random.default_rng(seed)
    R, P, C, B = 1 << logr, 1 << logp, 1 << logc, 1 << logb
    probes = rng.integers(0, R, P, dtype=np.uint32)
    keys = rng.permutation(R).astype(np.uint32)
    bkeys = rng.integers(0, R, B, dtype=np.uint32)
    out = {}

    cost = chaining_unique_cost(keys, R)
    want = (P, int(cost[probes].sum()))
    tbl = build_chaining_host(from_numpy_u32(keys, dev), R,
                              dense_direct=True, n_keys=R)
    tbl_bytes = tbl.memory_consumption()["total"]
    r = _streamed(lambda: stream_probe_chaining(tbl, probes, chunk_size=C,
                                                unique=True), dev)
    got = tuple(r.pop("out")[:2])
    if got != want:
        raise AssertionError(f"chaining stream: counters {got}, model "
                             f"{want}")
    out["chaining"] = dict(r, counters=dict(c_htProbe=got[0],
                                            c_htProbeCmp=got[1]),
                           table_bytes=tbl_bytes,
                           probe_one=chunk_probe_chaining(tbl, True))

    ncost, gsize = nested_cost_and_groups(bkeys, R, R)
    want = (int((gsize[probes] > 0).sum()), int(ncost[probes].sum()),
            int(gsize[probes].sum()))
    ntbl = build_nested_host(from_numpy_u32(bkeys, dev), R,
                             n_keys=int((gsize > 0).sum()), key_domain=R)
    ntbl_bytes = ntbl.memory_consumption()["total"]
    r = _streamed(lambda: stream_probe_nested(ntbl, probes, chunk_size=C),
                  dev)
    got = tuple(r.pop("out")[:3])
    if got != want:
        raise AssertionError(f"nested stream: counters {got}, model {want}")
    out["nested"] = dict(r, counters=dict(c_htProbe=got[0],
                                          c_htProbeCmp=got[1],
                                          c_unnest=got[2]),
                         table_bytes=ntbl_bytes,
                         probe_one=chunk_probe_nested(ntbl, 4 * C))
    streams = {"chaining": lambda: stream_probe_chaining(
                   tbl, probes, chunk_size=C, unique=True),
               "nested": lambda: stream_probe_nested(ntbl, probes,
                                                     chunk_size=C)}
    for name in ("chaining", "nested"):
        res = out[name]
        probe_one = res.pop("probe_one")
        res.update(logp=logp, logc=logc, probes_per_s=P / res["ms"] * 1e3)
        if timings:
            res.update(profiled_split(streams[name]))
            res["probe_only_ms"] = probe_only_ms(probe_one, probes, C, dev)
            res["copy_only_ms"], res["host_copy_ms"] = copy_only_ms(
                probes, C, dev)
            res["serial_ms"] = res["copy_only_ms"] + res["probe_only_ms"]
    if timings:
        out["h2d_gbps"] = h2d_gbps(C, dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logp", type=int, default=27, help="log2 #probes")
    ap.add_argument("--logr", type=int, default=20, help="log2 key domain")
    ap.add_argument("--logb", type=int, default=24,
                    help="log2 build rows of the nested table")
    ap.add_argument("--logc", type=int, default=22, help="log2 chunk size")
    ap.add_argument("--seed", type=int, default=20260817)
    args = ap.parse_args(argv)
    dev = require_cuda()
    print(card(), flush=True)
    res = run(dev, args.logp, args.logr, args.logb, args.logc, args.seed)
    for name in ("chaining", "nested"):
        print(json.dumps(dict(table=name, **res[name])), flush=True)
    print(json.dumps(dict(h2d_gbps=res["h2d_gbps"])), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
