"""Roofline micro-benchmarks of the port on one CUDA GPU.

Port of ``tools/roofline.py`` (lines 77-224): what the card gives per
operation at the main path's shapes (n = 2^24 probes, T = 2^20 table
entries), inputs from numpy seed 7.  Rows: an elementwise copy; ``torch``
gathers (random, sorted and from a 2 Ki table); a scatter; cumsum, cummax
and reverse cummin; ``run_boundaries`` through K3; the inverse permutation
as scatter and as sort; ``torch.sort`` 1-op and 2-op; the windowed lookup K2
and K2b for W in {1024, 2048, 4096, 8192}, each checked bit-equal to
``table[keys]``; sort + windowed; the (hi, lo) u64 pair.  Each prints ms,
ns/elem, GB/s and % of 3.35 TB/s.  Bytes count each input read once and
each output written once, at the dtypes the row uses.

The kernel section gives, for each hand kernel K1, K2, K2b, K3 and K4 at its
main-path shape, its time, the bound (its bytes over 3.35 TB/s) and the
time of the PyTorch call that computes the same function.

The strand section (the original's lines 226-252) times the nested probe
strand of n keys over a permutation of T keys three ways: the u32
key_direct strand, the u32 merged strand and the u64 merged strand (the
same keys with 0xAB << 40 set), each checked to unnest exactly n pairs, and
prints the u64 merged / u32 key_direct ratio (the JAX design's bar was at
most 2).

    python3 -m hashjoin3d_tpu_torch.tools.roofline [--quick] [--n 24] [--t 20]

Times come from CUDA events (:func:`~hashjoin3d_tpu_torch.utils.measure.
events_ms`); the card and its power limit print first.  Without a CUDA GPU
it raises.
"""

from __future__ import annotations

import argparse
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops import bitonic, windowed
from ..ops.layout import I32, from_numpy_u32, run_boundaries, widen_u64
from ..ops.nested import build_nested_host
from ..ops.scan import multi_scan
from ..ops.sort import probe_sort_chunk, window_for_chunk
from ..ops.strands_windowed import (_pad_table,
                                    keydirect_nested_strand_sorted,
                                    merged_nested_strand_sorted)
from ..utils.measure import (HBM_BYTES_PER_S, bound_ms, card, events_ms,
                             nbytes, require_cuda)

WINDOWS = (1024, 2048, 4096, 8192)


class Row(NamedTuple):
    name: str
    fn: Callable | None          #: None: the row was skipped (see note)
    inputs: tuple = ()
    per_elem: int = 1
    check: Callable | None = None  #: output -> bool
    note: str = ""
    library: Callable | None = None  #: the PyTorch call of the same function
    library_name: str = ""


def _outputs(out) -> tuple:
    if isinstance(out, dict):  # a strand's output: its tensors
        return tuple(v for v in out.values() if isinstance(v, torch.Tensor))
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _t(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def inputs(dev, log_n: int = 24, log_t: int = 20) -> dict:
    """The original's seed-7 inputs on ``dev``, drawn in its order (and
    after them, the K3 and K4 inputs of the kernel section and the strand
    section's build permutation and probes)."""
    n, T = 1 << log_n, 1 << log_t
    rng = np.random.default_rng(7)
    table_np = rng.integers(1, 2**32, T, dtype=np.uint32)
    idx_np = rng.integers(0, T, n).astype(np.int32)
    copy_np = rng.integers(0, 2**32, 1 << (log_n + 2), dtype=np.uint32)
    upd_np = rng.integers(0, 2**31, n, dtype=np.int32)
    skeys_np = np.sort(rng.integers(0, T, n).astype(np.uint32))
    perm_np = rng.permutation(np.arange(n, dtype=np.int32))
    wide_np = rng.integers(0, T + T // 4, n, dtype=np.uint32)
    buckets_np = np.sort(rng.integers(0, T, T).astype(np.int32))
    bk32_np = rng.permutation(np.arange(T, dtype=np.uint32))
    pk32_np = rng.integers(0, T, n, dtype=np.uint32)
    return dict(
        bk32=from_numpy_u32(bk32_np, dev), pk32=from_numpy_u32(pk32_np, dev),
        n=n, T=T, log_t=log_t, table=from_numpy_u32(table_np, dev),
        idx=_t(idx_np, dev), idx_sorted=_t(np.sort(idx_np), dev),
        copy=from_numpy_u32(copy_np, dev), upd=_t(upd_np, dev),
        skeys=from_numpy_u32(skeys_np, dev), perm=_t(perm_np, dev),
        wide=from_numpy_u32(wide_np, dev), buckets=_t(buckets_np, dev))


def table_rows(d: dict) -> list[Row]:
    """The roofline rows of the original, on the :func:`inputs` ``d``."""
    n, T, table, idx = d["n"], d["T"], d["table"], d["idx"]
    dev = idx.device
    idx_sorted, upd = d["idx_sorted"], d["upd"]
    idx64 = idx.long()
    small = table[:2048].clone()
    idx_small = idx % 2048
    zeros = torch.zeros(T, dtype=I32, device=dev)
    ones = torch.ones(n, dtype=I32, device=dev)
    perm, perm64 = d["perm"], d["perm"].long()
    row_ids = torch.arange(n, dtype=I32, device=dev)
    want_sorted = table[idx_sorted.long()]

    def scatter(target, index, vals):
        out = target.clone()
        out[index] = vals
        return out

    def sort2(k, v):
        s = torch.sort(k)
        return s.values, v[s.indices]

    rows = [
        Row(f"copy {d['copy'].numel() >> 20}Mi u32 (r+w)",
            lambda: d["copy"] + 1, (d["copy"],), d["copy"].numel()),
        Row(f"torch gather {n >> 20}Mi from {T >> 20}Mi",
            lambda: torch.index_select(table, 0, idx), (table, idx), n),
        Row("torch gather (sorted idx)",
            lambda: torch.index_select(table, 0, idx_sorted),
            (table, idx_sorted), n),
        Row("torch gather (2Ki table)",
            lambda: torch.index_select(small, 0, idx_small),
            (small, idx_small), n),
        Row("torch scatter n->T i32", lambda: scatter(zeros, idx64, upd),
            (zeros, idx64, upd), n),
        Row("cumsum i32", lambda: torch.cumsum(ones, 0, dtype=I32), (ones,),
            n),
        Row("cummax i32", lambda: torch.cummax(upd, 0).values, (upd,), n),
        Row("cummin i32 (reverse)",
            lambda: torch.cummin(upd.flip(0), 0).values.flip(0), (upd,), n),
        Row("run_boundaries (K3: 2 fused scans)",
            lambda: run_boundaries(d["skeys"], n), (d["skeys"],), n),
        Row("inv-perm scatter n->n i32",
            lambda: scatter(torch.empty_like(upd), perm64, upd),
            (perm64, upd), n),
        Row("inv-perm 2-op sort", lambda: sort2(perm, upd)[1], (perm, upd), n),
        Row("torch.sort i32 (1 op)", lambda: torch.sort(idx).values, (idx,),
            n),
        Row("torch.sort i32 + i32 (2 op)", lambda: sort2(idx, row_ids),
            (idx, row_ids), n),
    ]

    cover_w = None
    for W in WINDOWS:
        if T < W + 1024:
            rows.append(Row(f"windowed W={W}", None,
                            note=f"table {T} smaller than W + 1024"))
            continue
        if not windowed.windowed_coverage_ok(idx_sorted, T, W=W):
            rows.append(Row(f"windowed W={W}", None,
                            note="coverage FAILED (spread too wide)"))
            continue
        cover_w = cover_w or W
        for db in (False, True):
            rows.append(Row(
                f"windowed lookup {'K2b db' if db else 'K2'} W={W}",
                lambda W=W, db=db: windowed.windowed_lookup(
                    table, idx_sorted, W=W, db=db),
                (table, idx_sorted), n,
                check=lambda out: torch.equal(out, want_sorted)))
    if cover_w is None:
        rows.append(Row("sort + windowed, (hi, lo) pair", None,
                        note="no window covers the sorted stream"))
        return rows

    def sorted_pipeline():
        sk, rows_ = sort2(idx, row_ids)
        return windowed.windowed_lookup(table, sk, W=cover_w), rows_

    rows += [
        Row(f"sort + windowed (full pipeline, W={cover_w})", sorted_pipeline,
            (table, idx, row_ids), n,
            check=lambda out: torch.equal(out[0], want_sorted)),
        Row(f"windowed (hi, lo) u64 value pair W={cover_w}",
            lambda: (windowed.windowed_lookup(table, idx_sorted, W=cover_w),
                     windowed.windowed_lookup(table, idx_sorted, W=cover_w)),
            (table, table, idx_sorted), n,
            check=lambda out: all(torch.equal(o, want_sorted) for o in out)),
    ]
    return rows


def kernel_rows(d: dict) -> list[Row]:
    """K1, K2, K2b, K3 and K4 at the main path's shapes (the probe sort's
    segment and window policy of ``ops/sort.py``), each with the PyTorch
    call that computes the same function on the same inputs."""
    n, T, idx, log_t = d["n"], d["T"], d["idx"], d["log_t"]
    dev = idx.device
    seg = probe_sort_chunk(n, T) or n
    W = window_for_chunk(seg, T)
    table = _pad_table(d["table"], W)
    K = n // seg

    sk, _ = bitonic.bitonic_sort_packed_segmented(idx, seg, log_t)
    if not windowed.windowed_coverage_ok(sk, table.shape[0], W=W):
        raise RuntimeError(f"the segment-sorted stream is not covered at "
                           f"W={W}: not the main path's case")
    want_lookup = table[sk.long()]

    def sort_keys_equal(out):
        return torch.equal(out[0], torch.sort(idx.view(K, seg), dim=1)
                           .values.view(-1))

    b = d["buckets"]
    i = torch.arange(T, dtype=I32, device=dev)
    is_first = torch.ones(T, dtype=torch.bool, device=dev)
    is_first[1:] = b[1:] != b[:-1]
    fwd = (is_first.to(I32), torch.where(is_first, i, -1))

    wide = d["wide"]
    lid = torch.arange(n, dtype=I32, device=dev) % seg

    return [
        Row(f"K1 radix sort, keys + rows ({n >> 20}Mi keys < 2^{log_t},"
            f" segments {seg})",
            lambda: bitonic.bitonic_sort_packed_segmented(idx, seg, log_t),
            (idx,), n, sort_keys_equal,
            library=lambda: torch.sort(idx.view(K, seg), dim=1),
            library_name="torch.sort(keys.view(K, seg), dim=1)"),
        *[Row(f"{'K2b' if db else 'K2'} windowed_lookup (T {table.shape[0]},"
              f" {n >> 20}Mi segment-sorted keys, W {W})",
              lambda db=db: windowed.windowed_lookup(table, sk, W=W, db=db),
              (table, sk), n,
              lambda out: torch.equal(out, want_lookup),
              library=lambda: torch.index_select(table, 0, sk),
              library_name="torch.index_select (table[keys])")
          for db in (False, True)],
        Row(f"K3 multi_scan (sum, max over {T >> 20}Mi)",
            lambda: multi_scan(fwd, ("sum", "max")), fwd, T,
            lambda out: torch.equal(out[0],
                                    torch.cumsum(fwd[0], 0, dtype=I32)),
            library=lambda: (torch.cumsum(fwd[0], 0, dtype=I32),
                             torch.cummax(fwd[1], 0)),
            library_name="cumsum + cummax (two calls)"),
        Row(f"K4 radix sort (2-op take_min, {n >> 20}Mi keys, "
            f"segments {seg})",
            lambda: bitonic.bitonic_sort_segmented(wide, seg, payload=lid,
                                                   stable=False),
            (wide, lid), n,
            lambda out: torch.equal(out[0], torch.sort(
                wide.view(K, seg), dim=1).values.view(-1)),
            library=lambda: torch.sort(wide.view(K, seg), dim=1),
            library_name="torch.sort(keys.view(K, seg), dim=1)"),
    ]


#: the hi bits the strand section's u64 keys carry
U64_HI = 0xAB << 40
STRANDS = ("u32 keydirect nested strand", "u32 merged nested strand",
           "u64 merged nested strand")


def strand_rows(d: dict) -> list[Row]:
    """The nested probe strand of the n probes over the T-key permutation:
    u32 key_direct, u32 merged, u64 merged; each must unnest n pairs."""
    n, T = d["n"], d["T"]
    bk32, pk32 = d["bk32"], d["pk32"]
    bk64, pk64 = widen_u64(bk32) | U64_HI, widen_u64(pk32) | U64_HI
    tbl32 = build_nested_host(bk32, T, n_keys=T, key_domain=T)
    tbl64 = build_nested_host(bk64, T, n_keys=T)

    def unnests_all(out):
        return int(out["c_unnest"]) == n and int(out["c_htProbe"]) == n

    shape = f"({n >> 20}Mi probes, {T >> 20}Mi keys)"
    return [
        Row(f"{STRANDS[0]} {shape}",
            lambda: keydirect_nested_strand_sorted(tbl32, pk32, n),
            (pk32,), n, unnests_all),
        Row(f"{STRANDS[1]} {shape}",
            lambda: merged_nested_strand_sorted(tbl32, pk32, n),
            (pk32,), n, unnests_all),
        Row(f"{STRANDS[2]} {shape}",
            lambda: merged_nested_strand_sorted(tbl64, pk64, n),
            (pk64,), n, unnests_all),
    ]


def strand_ratio(results: list[dict]) -> float:
    """u64 merged over u32 key_direct, from :func:`run_rows`' results."""
    ms = {r["name"].split(" (")[0]: r["ms"] for r in results}
    return ms[STRANDS[2]] / ms[STRANDS[0]]


def run_rows(rows: list[Row], min_time: float, kernel_section: bool,
             out=print) -> list[dict]:
    """Check and time each row on the card; print one line each and return
    the results."""
    results = []
    for r in rows:
        if r.fn is None:
            out(f"{r.name:58s} skipped: {r.note}")
            continue
        got = r.fn()
        if r.check is not None and not r.check(got):
            raise AssertionError(f"{r.name}: WRONG RESULTS")
        n_bytes = nbytes(*r.inputs, *_outputs(got))
        ms = events_ms(r.fn, min_time)
        res = dict(name=r.name, ms=ms, ns_per_elem=ms * 1e6 / r.per_elem,
                   bytes=n_bytes, gbs=n_bytes / ms / 1e6,
                   hbm_pct=n_bytes / ms / 1e6 / (HBM_BYTES_PER_S / 1e9) * 100)
        if kernel_section:
            res["bound_ms"] = bound_ms(n_bytes)[0]
            res["library_ms"] = (events_ms(r.library, min_time)
                                 if r.library else None)
            res["library_name"] = r.library_name
            lib = (f"{res['library_ms']:9.4f} ms {r.library_name}"
                   if r.library else "no single call")
            out(f"{r.name:58s} {ms:9.4f} ms  bound {res['bound_ms']:.4f} ms "
                f"({n_bytes} B)  library {lib}")
        else:
            out(f"{r.name:58s} {ms:9.4f} ms  {res['ns_per_elem']:7.3f} "
                f"ns/elem  {res['gbs']:8.1f} GB/s  {res['hbm_pct']:5.1f}% HBM")
        results.append(res)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="0.2 s minimum per row instead of 0.5 s")
    ap.add_argument("--n", type=int, default=24, help="log2 #probes")
    ap.add_argument("--t", type=int, default=20, help="log2 table size")
    args = ap.parse_args(argv)
    dev = require_cuda()
    mt = 0.2 if args.quick else 0.5
    print(f"card: {card()}; n = 2^{args.n}, T = 2^{args.t}", flush=True)
    d = inputs(dev, args.n, args.t)
    rows = run_rows(table_rows(d), mt, False)
    print("\n| op | ms | ns/elem | GB/s | % of 3.35 TB/s |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['name']} | {r['ms']:.4f} | {r['ns_per_elem']:.3f} | "
              f"{r['gbs']:.1f} | {r['hbm_pct']:.1f} |")
    print("\nkernel section", flush=True)
    ks = run_rows(kernel_rows(d), mt, True)
    print("\n| kernel | ms | bound ms (bytes) | library call | library ms |")
    print("|---|---|---|---|---|")
    for r in ks:
        lib = ("—" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        print(f"| {r['name']} | {r['ms']:.4f} | {r['bound_ms']:.4f} "
              f"({r['bytes']}) | {r['library_name'] or '—'} | {lib} |")
    print("\nstrand section", flush=True)
    st = run_rows(strand_rows(d), mt, False)
    print(f"u64 merged / u32 keydirect nested strand: {strand_ratio(st):.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
