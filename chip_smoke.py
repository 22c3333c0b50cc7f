#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: exp-1 plan Csr at R20/S24.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It builds the hand-written kernels from ``hashjoin3d_tpu_torch/csrc`` and
drives the port's main path, the reference's headline configuration
(``main_experiment1 -R 20 -S 24 --no-skew -t 0 -b 1``: build 2^20 keys,
probe 2^24 foreign keys).  Phases, any failure exits non-zero:

0. the card and its power limit (``nvidia-smi``), the kernel build time;
1. each kernel against its plain PyTorch version on the same CUDA tensors at
   the main-path shapes, bit-equal: K2 (words, its per-chunk coverage
   flags and their count, as ``safe_lookup`` calls it), K3 (the build's two
   calls, then ragged sizes up to 2^24 + 77, four columns, maxpair both
   ways, an unaligned column; its host and device time a call), and the
   radix sorts K1 (keys and
   rows) and K4 (1-op, take_min with an ascending payload, stable with a
   shuffled payload); then K1 and K4 at other segment sizes (256 .. 8192 on
   the one-block path, 2^14 and 2^15 on the multi-tile path) and key
   widths, bit-equal except take_min with a shuffled payload, whose
   equal-key payload order is free (keys equal, each segment's payload a
   permutation that carries its own key);
2. ``Experiment1(20, 24, Csr, device="cuda")``: its CSV c_* and ht_* columns
   equal the reference's Csr row (``artifacts/r5/e1_t0c.csv``),
   ``route_worst`` is 0, the result pairs equal (as a multiset) those of the
   same build and strand run with the plain versions on CPU copies;
3. a Csr probe with misses (2^24 keys, numpy seed 0, over
   [0, 2^20 + 2^18)): counters bit-equal and pairs multiset-equal to the
   CPU plain run;
4. launch counts, reset just before phase 2: K1, K2, K3 launched in phase 2,
   K4 in phase 3 (R20/S24 never misses, so its main path bypasses K4);
5. K2b, the kernel only the measurement tools reach, bit-equal to K2 (with
   and without coverage) and to the plain lookup on phase 2's table, at
   W = 8192 and 32768, on the K1-sorted probes and five edge streams made
   from them (-1 holes, a base that moves back, a base that jumps, an
   all-miss chunk whose base wraps, keys past the table), at W = 65536 on a
   2^17-word table, on a zero-padded table (Tv < T) and on a key view at
   element offset 1; ``safe_lookup`` on the card equal to its CPU run on a
   route-1 stream (64 uncovered chunks) and a route-2 stream (the unsorted
   S.a); P8 equal to its plain version at five (row offset, rows),
   and its host and device time per call beside ``clone``'s; P5 equal to
   its plain version at C = 128, 1024, 4096, 8192 and 384; P3 down the
   rows at block_rows 8 .. rows (2^15 and 4096 rows, and three odd
   shapes) and P4 at 16, 48 and 2^15 rows, three matrices and x up to
   2^24 - 1, bit-equal to their plain versions;
   P1-P9 (``ops/probes.py``) through the mosaic_probe runner, each
   equal to its plain version at the TPU probes' sizes, counts reset just
   before it: each P kernel must launch there; then the roofline and
   csrprof paths (``hashjoin3d_tpu_torch/tools``) driven once with a short
   minimum time, counts reset just before them: K2b must launch there, and
   csrprof's ``safe_lookup`` stages print.

Prints one JSON line of per-kernel results, then, last,
``{"ok": true, "device": {...}}``.  ``launches`` there is the main path's
count (phase 2 alone); ``miss_probe_launches`` is phase 3's,
``probe_tool_launches`` phase 5's probe runner's (its check and timed
launches) and ``tool_launches`` phase 5's roofline and csrprof path's.  ``bound_ms`` is the kernel's bytes
(each input read once, each output written once) over 3.35 TB/s, or for P4
its u8 tensor-core operations over 1979 TOP/s where that is larger;
``library_ms`` the PyTorch call that computes the same function (null where
there is none).  A probe with several cases (P3, P5, P7) reports the sums
over its cases.  Nothing here imports JAX.
"""

from __future__ import annotations

import csv
import io
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
REFERENCE_CSV = REPO / "artifacts" / "r5" / "e1_t0c.csv"
LOG2_R, LOG2_S = 20, 24
SEGMENT, WINDOW, KEY_BITS = 1 << 18, 8192, 20

#: name -> (source, TPU kernel it replaces, launch-count key)
KERNELS = {
    "K1 bitonic_sort_packed_segmented": (
        "hashjoin3d_tpu_torch/csrc/radix.cu",
        "hashjoin3d_tpu/ops/bitonic.py:290", "bitonic_sort_packed_segmented"),
    "K2 windowed_lookup": (
        "hashjoin3d_tpu_torch/csrc/windowed.cu",
        "hashjoin3d_tpu/ops/windowed.py:168", "windowed_lookup"),
    "K3 multi_scan": (
        "hashjoin3d_tpu_torch/csrc/scan.cu",
        "hashjoin3d_tpu/ops/scan.py:224", "multi_scan"),
    "K4 bitonic_sort_segmented": (
        "hashjoin3d_tpu_torch/csrc/radix.cu",
        "hashjoin3d_tpu/ops/bitonic.py:247", "bitonic_sort_segmented"),
    "K2b windowed_lookup db": (
        "hashjoin3d_tpu_torch/csrc/windowed.cu",
        "hashjoin3d_tpu/ops/windowed.py:115", "windowed_lookup_db"),
}
TOOL_MIN_TIME = 0.005
#: P8's (row offset, rows) checks; -8 is the last 8 rows
P8_CASES = ((3, 8), (0, 1), (7, 64), (-8, 8), (5, 13))
#: P5's block sizes checked besides the runner's cases: the smallest and
#: largest C, the runner's two, and one that is no power of two
P5_BLOCKS = (128, 1024, 4096, 8192, 384)
#: P3's (rows, block_rows) checks down the rows besides the runner's case:
#: 8 .. rows at 2^15 and 4096 rows, and blocks of 24 (8-row segments,
#: chunks shorter than a tile), 384 (one block a chunk, a partial tile) and
#: 1536 (three tiles a block) at 3 x 2^12 rows
P3_ROW_BLOCKS = (*dict.fromkeys((rows, block) for rows in (1 << 15, 4096)
                                for block in (8, 64, 512, 4096, rows)),
                 (12288, 24), (12288, 384), (12288, 1536))
#: P4's row counts checked besides the runner's case
P4_ROWS = (16, 48, 1 << 15)


class SmokeFailure(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds per call on CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def bound(*tensors: torch.Tensor) -> dict:
    """``bound_ms`` of a kernel that reads its inputs and writes its outputs
    (``tensors``) once each, over the card's memory rate."""
    from hashjoin3d_tpu_torch.utils.measure import bound_ms, nbytes

    ms, by = bound_ms(nbytes(*tensors))
    return dict(bound_ms=ms, bound_by=by)


def check_segment_rows(keys_in, sk, rows, chunk, what):
    """rows: segment-local ids, a permutation per segment, each carrying
    its own key (keys_in[segment base + row] == sorted key)."""
    K = keys_in.shape[0] // chunk
    base = (torch.arange(K, device=rows.device, dtype=torch.int64)
            * chunk)[:, None]
    r2 = rows.view(K, chunk).to(torch.int64)
    require(torch.equal(torch.sort(r2, dim=1).values,
                        torch.arange(chunk, device=rows.device)
                        .expand(K, chunk)),
            f"{what}: row ids are not a permutation per segment")
    require(torch.equal(keys_in[(r2 + base).view(-1)], sk),
            f"{what}: a row id does not carry its key")


def same(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def check_sort_shapes(dev):
    """K1 and K4 at other segment sizes and key widths than the main path's
    (2^16 keys; 256 .. 8192 take the one-block path, 2^14 and 2^15 the
    multi-tile passes): bit-equal to the plain sort, except take_min with a
    shuffled payload (keys equal, rows a per-segment permutation carrying
    their keys)."""
    from hashjoin3d_tpu_torch.ops import bitonic
    from hashjoin3d_tpu_torch.ops.layout import I32

    gen = torch.Generator(device=dev).manual_seed(1)
    n = 1 << 16
    for chunk in (256, 2048, 1 << 13, 1 << 14, 1 << 15):
        K = n // chunk
        lid = torch.arange(n, dtype=I32, device=dev) % chunk
        shuffled = torch.argsort(torch.rand((K, chunk), generator=gen,
                                            device=dev), dim=1).to(I32)
        shuffled = shuffled.view(-1)
        keys = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                             device=dev, dtype=I32) >> 20  # heavy ties
        (g1,) = bitonic.bitonic_sort_segmented(keys, chunk, unsigned=False)
        (w1,) = bitonic.plain_sort_segmented(keys, chunk, unsigned=False)
        require(torch.equal(g1, w1), f"K4 1-op signed, chunk {chunk}")
        for pay, what in ((lid, "ascending"), (shuffled, "shuffled")):
            got = bitonic.bitonic_sort_segmented(keys, chunk, payload=pay)
            require(same(got, bitonic.plain_sort_segmented(keys, chunk, pay)),
                    f"K4 2-op stable u32, {what} payload, chunk {chunk}")
        got = bitonic.bitonic_sort_segmented(keys, chunk, payload=lid,
                                             unsigned=False, stable=False)
        require(same(got, bitonic.plain_sort_segmented(
            keys, chunk, lid, unsigned=False)),
            f"K4 2-op take_min i32, chunk {chunk}")
        gk, gr = bitonic.bitonic_sort_segmented(keys, chunk, payload=shuffled,
                                                stable=False)
        require(torch.equal(gk, bitonic.plain_sort_segmented(keys, chunk)[0]),
                f"K4 2-op take_min u32, shuffled payload, chunk {chunk}")
        by_payload = torch.empty_like(keys)  # each segment's keys by payload
        seg_base = torch.arange(n, device=dev) // chunk * chunk
        by_payload[shuffled + seg_base] = keys
        check_segment_rows(by_payload, gk, gr, chunk, f"K4 take_min {chunk}")
        flat = torch.full_like(keys, 7)  # every digit constant: no live pass
        require(same(bitonic.bitonic_sort_segmented(
            flat, chunk, payload=lid, stable=False), (flat, lid)),
            f"K4 constant keys, chunk {chunk}")
        for key_bits in (8, 20, 31):
            small = keys & ((1 << key_bits) - 1)
            require(same(bitonic.bitonic_sort_packed_segmented(
                small, chunk, key_bits), bitonic.plain_sort_segmented(
                    small, chunk, lid)), f"K1 chunk {chunk} bits {key_bits}")


def k3_cases(fwd, nxt, gen):
    """(label, columns, ops, reverse) of phase 1's K3 checks: the build's
    two calls; (sum, max) both ways over full-range columns at 1, one tile
    - 1, one tile + 1, three tiles + 77 and 2^24 + 77 elements; four
    columns (sum, max, min, sum); maxpair both ways with heavy key ties;
    two maxpairs; (min, maxpair, max); a column at element offset 1 (4-byte
    loads)."""
    from hashjoin3d_tpu_torch.ops import scan
    from hashjoin3d_tpu_torch.ops.layout import I32

    dev = fwd[0].device

    def cols(k, n, lo=-2**31, hi=2**31 - 1):
        return tuple(torch.randint(lo, hi, (n,), generator=gen, device=dev,
                                   dtype=I32) for _ in range(k))

    def pair(n):
        return cols(1, n, -50, 50) + cols(1, n)

    tile = scan.tile()
    m = (1 << LOG2_R) + 77
    out = [("build", fwd, ("sum", "max"), False),
           ("build", (nxt,), ("min",), True)]
    for n in (1, tile - 1, tile + 1, 3 * tile + 77, (1 << 24) + 77):
        c = cols(2, n)
        out += [(f"n = {n}", c, ("sum", "max"), rev) for rev in (False, True)]
    four = cols(4, m)
    p = pair(m)
    out += [("four columns", four, ("sum", "max", "min", "sum"), rev)
            for rev in (False, True)]
    out += [("maxpair", p, ("maxpair",), rev) for rev in (False, True)]
    out += [("two maxpairs", p + pair(m), ("maxpair", "maxpair"), True),
            ("min, maxpair, max", cols(1, m) + p + cols(1, m),
             ("min", "maxpair", "max"), False)]
    view = cols(1, m + 1)[0][1:]
    require(view.data_ptr() % 16 == 4, "the K3 view is not unaligned")
    out += [("offset view", (view,), ("sum",), rev) for rev in (False, True)]
    return out


def phase1_kernels(rk, sa, ops):
    """Each kernel vs its plain version at the main-path shapes."""
    from hashjoin3d_tpu_torch.ops import bitonic, scan, windowed
    from hashjoin3d_tpu_torch.ops.hashing import bucket_of, hash_key
    from hashjoin3d_tpu_torch.ops.layout import I32
    from hashjoin3d_tpu_torch.utils.measure import host_device_us

    results = {}
    dev = sa.device
    # K1: the probe sort of S.a (2^24 keys < 2^20, 2^18 segments)
    sk, rows = bitonic.bitonic_sort_packed_segmented(sa, SEGMENT, KEY_BITS)
    lid = torch.arange(sa.shape[0], dtype=I32, device=dev) % SEGMENT
    psk, prows = bitonic.plain_sort_segmented(sa, SEGMENT, lid)
    require(torch.equal(sk, psk), "K1: keys differ from the plain sort")
    require(torch.equal(rows, prows), "K1: rows differ from the plain sort")
    K = sa.shape[0] // SEGMENT
    results["K1 bitonic_sort_packed_segmented"] = dict(
        max_abs_err=max(max_abs_err(sk, psk), max_abs_err(rows, prows)),
        ms=cuda_ms(lambda: bitonic.bitonic_sort_packed_segmented(
            sa, SEGMENT, KEY_BITS)),
        plain_ms=cuda_ms(lambda: bitonic.plain_sort_segmented(
            sa, SEGMENT, lid)),
        library_ms=cuda_ms(lambda: torch.sort(sa.view(K, SEGMENT), dim=1)),
        **bound(sa, sk, rows))

    # K2: the packed direct words of the sorted probes and the chunks its
    # windows miss, as safe_lookup calls it (T = Tv = 2^20, W = 8192)
    direct = ops["table"].direct
    T = direct.shape[0]
    got = windowed.windowed_lookup_covered(direct, sk, T, W=WINDOW)
    want = windowed.windowed_lookup_covered_plain(direct, sk, T, W=WINDOW)
    require(same(got, want), "K2: words, bad or nbad differ from the plain "
            "lookup")
    require(int(got[2]) == 0, "K2: the main stream has uncovered chunks")
    results["K2 windowed_lookup"] = dict(
        max_abs_err=max(max_abs_err(g, w) for g, w in zip(got, want)),
        ms=cuda_ms(lambda: windowed.windowed_lookup_covered(
            direct, sk, T, W=WINDOW)),
        k2b_ms_same_call=cuda_ms(lambda: windowed.windowed_lookup(
            direct, sk, W=WINDOW, db=True)),
        plain_ms=cuda_ms(lambda: windowed.windowed_lookup_covered_plain(
            direct, sk, T, W=WINDOW)),
        library_ms=cuda_ms(lambda: torch.index_select(direct, 0, sk)),
        **bound(direct, sk, got[0], got[1]))

    # K3: run_boundaries' scans over the build's sorted bucket column, then
    # ragged sizes, four columns, maxpair both ways, an unaligned view
    b = bucket_of(hash_key(rk), 1 << LOG2_R)
    b_sorted = torch.sort(b, stable=True).values
    i = torch.arange(b.shape[0], dtype=I32, device=dev)
    is_first = torch.ones_like(b, dtype=torch.bool)
    is_first[1:] = b_sorted[1:] != b_sorted[:-1]
    fwd = (is_first.to(I32), torch.where(is_first, i, -1))
    nxt = torch.full_like(i, b.shape[0])
    nxt[:-1] = torch.where(is_first, i, b.shape[0])[1:]
    gen = torch.Generator(device=dev).manual_seed(0)
    err = 0
    for what, cols, op, rev in k3_cases(fwd, nxt, gen):
        got = scan.multi_scan(cols, op, reverse=rev)
        want = scan.multi_scan_plain(cols, op, reverse=rev)
        for g, w in zip(got, want):
            require(torch.equal(g, w), f"K3 {what} {op} reverse={rev}: "
                    f"differs")
            err = max(err, max_abs_err(g, w))
    host_us, device_us = host_device_us(
        lambda: scan.multi_scan(fwd, ("sum", "max")))
    rev_host_us, rev_device_us = host_device_us(
        lambda: scan.multi_scan((nxt,), ("min",), reverse=True))
    results["K3 multi_scan"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: scan.multi_scan(fwd, ("sum", "max"))),
        host_us=host_us, device_ms=device_us / 1e3,
        reverse_min_ms=cuda_ms(lambda: scan.multi_scan(
            (nxt,), ("min",), reverse=True)),
        reverse_min_host_us=rev_host_us,
        reverse_min_device_ms=rev_device_us / 1e3,
        plain_ms=cuda_ms(lambda: scan.multi_scan_plain(fwd, ("sum", "max"))),
        # no single call: cumsum + cummax, two calls
        library_ms=cuda_ms(lambda: (torch.cumsum(fwd[0], 0, dtype=I32),
                                    torch.cummax(fwd[1], 0))),
        **bound(*fwd, *fwd))

    # K4 (a) 1-op signed: miss-walk bucket ids with -1 dead markers
    bucket_ids = bucket_of(hash_key(sa), 1 << LOG2_R)
    dead = torch.rand(sa.shape, generator=gen, device=dev) < 0.3
    bucket_ids = torch.where(dead, -1, bucket_ids)
    (got1,) = bitonic.bitonic_sort_segmented(bucket_ids, SEGMENT,
                                             unsigned=False)
    (want1,) = bitonic.plain_sort_segmented(bucket_ids, SEGMENT,
                                            unsigned=False)
    require(torch.equal(got1, want1), "K4 1-op: differs from the plain sort")
    # K4 (b) 2-op u32, take_min ties: probe keys past the packed domain,
    # the ascending row ids as payload (input order on ties = the plain
    # sort's order)
    wide = ops["wide_keys"]
    gk, gr = bitonic.bitonic_sort_segmented(wide, SEGMENT, payload=lid,
                                            stable=False)
    wk, wr = bitonic.plain_sort_segmented(wide, SEGMENT, lid)
    require(torch.equal(gk, wk), "K4 2-op: keys differ from the plain sort")
    require(torch.equal(gr, wr), "K4 2-op: rows differ from the plain sort")
    # K4 (c) 2-op u32 stable, a shuffled payload: lexicographic
    pay = torch.randint(-2**31, 2**31 - 1, wide.shape, generator=gen,
                        device=dev, dtype=I32) >> 16
    got = bitonic.bitonic_sort_segmented(wide, SEGMENT, payload=pay)
    want = bitonic.plain_sort_segmented(wide, SEGMENT, pay)
    require(same(got, want), "K4 2-op stable: differs from the plain sort")
    results["K4 bitonic_sort_segmented"] = dict(
        max_abs_err=max(max_abs_err(got1, want1), max_abs_err(gk, wk),
                        max_abs_err(gr, wr),
                        *(max_abs_err(g, w) for g, w in zip(got, want))),
        ms=cuda_ms(lambda: bitonic.bitonic_sort_segmented(
            wide, SEGMENT, payload=lid, stable=False)),
        plain_ms=cuda_ms(lambda: bitonic.plain_sort_segmented(
            wide, SEGMENT, lid)),
        library_ms=cuda_ms(lambda: torch.sort(wide.view(K, SEGMENT), dim=1)),
        **bound(wide, lid, gk, gr))
    return results


def value_cols(header):
    """The columns a CSV row must reproduce exactly (counters, table shape,
    parameters); times and reps legitimately differ."""
    keep = {"plan", "ht_impl", "build", "probe", "ht_buckets", "ht_fracEmpty",
            "cc0_avg", "cc0_min", "cc0_max", "cc1_avg", "cc1_min", "cc1_max",
            "fkMax", "numDvSa", "log2CardR", "log2CardS", "skew", "t", "b"}
    return [i for i, c in enumerate(header) if c.startswith("c_") or c in keep]


def csr_row(text):
    rows = list(csv.reader(io.StringIO(text), delimiter=";"))
    return rows[0], next(r for r in rows[1:] if r[9] == "Csr")


def pairs_multiset_key(out: dict) -> torch.Tensor:
    """A strand's hit pairs as one sorted int64 column
    (probe_row << 32 | build_row): equal multisets give equal columns."""
    hit = out["probe_row"] >= 0
    packed = (out["probe_row"][hit].to(torch.int64) * (1 << 32)
              + out["build_row"][hit].to(torch.int64))
    return torch.sort(packed).values


def same_join(got, want, what):
    for k in ("c_htProbe", "c_htProbeCmp", "total"):
        require(int(got[k]) == int(want[k]),
                f"{what}: {k} {int(got[k])} != plain {int(want[k])}")
    require(torch.equal(pairs_multiset_key(got).cpu(),
                        pairs_multiset_key(want)),
            f"{what}: result pairs differ from the plain run")


def edge_streams(sk, T):
    """The K2b edge streams at full size, from the K1-sorted probes ``sk``
    (2^18-key segments, each sorted over [0, T)): sorted; 20% -1 holes
    (seed 2); rolled by a third of a chunk, so each segment's first keys
    fall mid-chunk and the base moves back there; half the keys in the
    table's bottom quarter and half in its top (the base jumps past any
    window); chunk 5 all ``I32_MIN + 3`` (``kmax - W`` wraps); the last
    1.5 chunks past the table, the last 3 keys ``I32_MAX``."""
    from hashjoin3d_tpu_torch.ops.windowed import DEFAULT_C as C

    n, dev = sk.shape[0], sk.device
    gen = torch.Generator(device=dev).manual_seed(2)
    i = torch.arange(n, device=dev)
    wrap = sk.clone()
    wrap[5 * C:6 * C] = -2**31 + 3
    past = sk.clone()
    past[-3 * C // 2:] = T + torch.arange(3 * C // 2, device=dev,
                                          dtype=sk.dtype)
    past[-3:] = 2**31 - 1
    return {
        "sorted": sk,
        "holes": torch.where(torch.rand(sk.shape, generator=gen,
                                        device=dev) < 0.2, -1, sk),
        "new_segment": torch.roll(sk, C // 3),
        "gap": torch.where(i < n // 2, sk >> 2, (sk >> 2) + 3 * T // 4),
        "all_miss_wrap": wrap,
        "past_table": past}


def lookup_cases(direct, sk):
    """(label, table, keys, Tv, W) of phase 5's lookup checks: every edge
    stream at W = 8192 and 32768 (T = 2^20, 2^24 keys); W = 65536 on a
    2^17-word table (the keys >> 3, each segment's last keys moved below
    its chunk's window); a table of 2^20 - 300 values zero-padded to 2^20
    (Tv < T) on the rolled stream; the rolled stream as a key view at
    element offset 1 (4-byte key loads)."""
    from hashjoin3d_tpu_torch.ops.strands_windowed import _pad_table
    from hashjoin3d_tpu_torch.ops.windowed import DEFAULT_C as C

    T = direct.shape[0]
    streams = edge_streams(sk, T)
    out = [(f"{what}, W = {W}", direct, keys, T, W)
           for what, keys in streams.items() for W in (WINDOW, 32768)]
    small = (sk >> 3).view(-1, SEGMENT)
    small[:, -C // 2:] = 0
    out.append(("W = 65536, T = 2^17", direct[:1 << 17].clone(),
                small.view(-1), 1 << 17, 65536))
    rolled = streams["new_segment"]
    out.append(("padded table, Tv = 2^20 - 300",
                _pad_table(direct[:T - 300], WINDOW), rolled, T - 300, WINDOW))
    view = torch.empty(rolled.shape[0] + 1, dtype=rolled.dtype,
                       device=rolled.device)
    view[1:] = rolled
    require(view[1:].data_ptr() % 16 == 4, "the key view is not unaligned")
    out.append(("key view at offset 1", direct, view[1:], T, WINDOW))
    return out


def phase5_k2b(direct, sa, dev):
    """K2 (words, bad, nbad), K2 without coverage and K2b bit-equal to each
    other and to the plain lookup on every case of :func:`lookup_cases`;
    times at W = 8192 on the main path's sorted stream."""
    from hashjoin3d_tpu_torch.ops import bitonic, windowed

    sk, _ = bitonic.bitonic_sort_packed_segmented(sa, SEGMENT, KEY_BITS)
    err = 0
    for what, table, keys, Tv, W in lookup_cases(direct, sk):
        db = windowed.windowed_lookup(table, keys, W=W, db=True)
        k2 = windowed.windowed_lookup(table, keys, W=W)
        cov = windowed.windowed_lookup_covered(table, keys, Tv, W=W)
        plain = windowed.windowed_lookup_covered_plain(table, keys, Tv, W=W)
        require(torch.equal(db, k2), f"K2b differs from K2 ({what})")
        require(torch.equal(db, plain[0]), f"K2b differs from plain ({what})")
        require(same(cov, plain), f"K2 with coverage differs from plain "
                f"({what}): nbad {int(cov[2])} vs {int(plain[2])}")
        err = max(err, max_abs_err(db, plain[0]))
    return dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: windowed.windowed_lookup(direct, sk, W=WINDOW,
                                                    db=True)),
        k2_ms_same_call=cuda_ms(lambda: windowed.windowed_lookup(
            direct, sk, W=WINDOW)),
        k2_covered_ms_same_call=cuda_ms(lambda: windowed.
                                        windowed_lookup_covered(
                                            direct, sk, direct.shape[0],
                                            W=WINDOW)),
        w32768_ms=cuda_ms(lambda: windowed.windowed_lookup(
            direct, sk, W=32768, db=True)),
        plain_ms=cuda_ms(lambda: windowed.windowed_lookup_plain(
            direct, sk, W=WINDOW)),
        library_ms=cuda_ms(lambda: torch.index_select(direct, 0, sk)),
        **bound(direct, sk, sk))


def phase5_safe_lookup(direct, sa):
    """``safe_lookup`` on the card equal, in words, ``route_worst`` and
    ``route_nbad``, to the same call on CPU copies (plain versions): the
    K1-sorted probes rolled by a third of a chunk (one uncovered chunk at
    each of the 64 segment starts, under the patch cap of 256: route 1) and
    the unsorted S.a (every chunk uncovered: route 2)."""
    from hashjoin3d_tpu_torch.ops import bitonic
    from hashjoin3d_tpu_torch.ops import strands_windowed as sw

    sk, _ = bitonic.bitonic_sort_packed_segmented(sa, SEGMENT, KEY_BITS)
    rolled = edge_streams(sk, direct.shape[0])["new_segment"]
    lookup = sw._with_route(lambda v, k: {"out": sw.safe_lookup(
        v, k, W=WINDOW)})
    routes = {}
    for what, keys, route in (("rolled", rolled, sw.ROUTE_PATCHED),
                              ("unsorted", sa, sw.ROUTE_GATHER)):
        got = lookup(direct, keys)
        want = lookup(direct.cpu(), keys.cpu())
        require(torch.equal(got["out"].cpu(), want["out"]),
                f"safe_lookup ({what}): words differ from the CPU run")
        for k in ("route_worst", "route_nbad"):
            require(got[k] == want[k], f"safe_lookup ({what}): {k} "
                    f"{got[k]} vs {want[k]} on the CPU")
        require(got["route_worst"] == route, f"safe_lookup ({what}): route "
                f"{got['route_worst']}, not {route}")
        routes[what] = (got["route_worst"], got["route_nbad"])
    require(routes["rolled"][1] == 1 << (LOG2_S - 18),
            f"safe_lookup (rolled): {routes['rolled'][1]} uncovered chunks")
    return routes


def phase5_p8(dev):
    """P8 equal to its plain version at each (row offset, rows) checked,
    on 2048 rows of 128 words; its host and device time per call beside
    ``clone``'s of the same rows."""
    from hashjoin3d_tpu_torch.ops import probes
    from hashjoin3d_tpu_torch.utils.measure import host_device_us

    src = torch.arange(1 << 18, dtype=torch.int32, device=dev).view(-1, 128)
    for off, nrows in P8_CASES:
        off = off % src.shape[0]
        require(torch.equal(probes.row_copy(src, off, nrows),
                            probes.row_copy_plain(src, off, nrows)),
                f"P8 differs from plain at row {off}, {nrows} rows")
    p8 = host_device_us(lambda: probes.row_copy(src, 3))
    clone = host_device_us(lambda: src[3:11].clone())
    return dict(p8_host_us=p8[0], p8_device_us=p8[1],
                clone_host_us=clone[0], clone_device_us=clone[1])


def phase5_p5(dev):
    """P5 bit-equal to its plain version at each C of ``P5_BLOCKS`` on 2^22
    random words, C = 384 on 3 x 2^20 (tiles of 3840 words, the last one
    partial)."""
    from hashjoin3d_tpu_torch.ops import probes

    gen = torch.Generator(device=dev).manual_seed(5)
    for C in P5_BLOCKS:
        n = 3 << 20 if C == 384 else 1 << 22
        x = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        perm = torch.randperm(C, generator=gen, device=dev).to(torch.int32)
        require(torch.equal(probes.permute(x, perm),
                            probes.permute_plain(x, perm)),
                f"P5 differs from its plain version at C = {C}")


def phase5_p3_p4(dev):
    """P3 down the rows at each (rows, block_rows) of ``P3_ROW_BLOCKS`` on
    full-range int32 words, and P4 at each row count of ``P4_ROWS`` with
    the reversal, a random permutation and a 0/1 matrix with a column of
    all ones, on x below 2^24 with its first and last rows 2^24 - 1 and on
    x all 2^24 - 1: each bit-equal to its plain version."""
    from hashjoin3d_tpu_torch.ops import probes

    gen = torch.Generator(device=dev).manual_seed(6)
    for rows, block in P3_ROW_BLOCKS:
        x = torch.randint(-2**31, 2**31 - 1, (rows, 128), generator=gen,
                          device=dev, dtype=torch.int32)
        require(torch.equal(probes.cumsum(x, 0, block),
                            probes.cumsum_plain(x, 0, block)),
                f"P3 axis 0 differs from its plain version at rows {rows}, "
                f"block_rows {block}")
    eye = torch.eye(128, dtype=torch.int32, device=dev)
    zero_one = (torch.rand((128, 128), generator=gen, device=dev)
                < 0.05).to(torch.int32)
    zero_one[:, 7] = 1
    mats = {"reversal": eye.flip(0),
            "permutation": eye[torch.randperm(128, generator=gen,
                                              device=dev)],
            "0/1 with a column of ones": zero_one}
    top = (1 << 24) - 1
    for rows in P4_ROWS:
        x = torch.randint(0, 1 << 24, (rows, 128), generator=gen, device=dev,
                          dtype=torch.int32)
        x[0] = x[-1] = top
        for what, xs in (("x < 2^24", x),
                         ("x = 2^24 - 1", torch.full_like(x, top))):
            for name, p in mats.items():
                require(torch.equal(probes.onehot_matmul(xs, p),
                                    probes.onehot_matmul_plain(xs, p)),
                        f"P4 differs from its plain version at rows {rows}, "
                        f"{name}, {what}")


def phase5_probes(dev):
    """P1-P9 through the mosaic_probe runner, counts reset just before it:
    each case equal to its plain version, results summed over each probe's
    cases, and the runner's launch counts; then each probe's device time a
    call (profiler, summed over its cases) as ``device_ms``."""
    from hashjoin3d_tpu_torch import kernels
    from hashjoin3d_tpu_torch.tools import mosaic_probe
    from hashjoin3d_tpu_torch.utils.measure import host_device_us

    kernels.reset_launch_counts()
    runs = mosaic_probe.run(dev, "", 0.02,
                            lambda line: print("phase 5 probe" + line))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    out = {}
    for r in runs:
        require(r["ok"], f"{r['probe']} {r['label']}: differs from its plain "
                f"version (max_abs_err {r['max_abs_err']})")
        acc = out.setdefault(r["probe"], dict(
            max_abs_err=0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
            bound_by=r["bound_by"], cases={}))
        acc["max_abs_err"] = max(acc["max_abs_err"], r["max_abs_err"])
        for k in ("ms", "plain_ms", "bound_ms"):
            acc[k] += r[k]
        acc["library_ms"] = (None if acc["library_ms"] is None
                             or r["library_ms"] is None
                             else acc["library_ms"] + r["library_ms"])
        acc["cases"][r["label"]] = r["ms"]
    for pid, probe in mosaic_probe.PROBES.items():
        require(pid in out, f"{pid}: the runner has no case")
        require(launches[probe.key] > 0,
                f"{probe.key} not launched on the probe runner's path")
    for c in mosaic_probe.cases(dev):  # after the counts: not the path's
        out[c.probe]["device_ms"] = out[c.probe].get("device_ms", 0.0) + (
            host_device_us(c.run, calls=1000, profiled=50)[1] / 1e3)
    return out, launches


def phase5_tools(dev):
    """The roofline rows, its kernel section and the csrprof stages, once
    each with a short minimum time; the launch counts of that path."""
    from hashjoin3d_tpu_torch import kernels
    from hashjoin3d_tpu_torch.tools import csrprof, roofline

    kernels.reset_launch_counts()
    d = roofline.inputs(dev, LOG2_S, LOG2_R)
    def log(line):
        print("phase 5 roofline " + line)

    roofline.run_rows(roofline.table_rows(d), TOOL_MIN_TIME, False, log)
    roofline.run_rows(roofline.kernel_rows(d), TOOL_MIN_TIME, True, log)
    del d
    times = csrprof.run(csrprof.stages(dev, LOG2_S, LOG2_R), 1 << LOG2_S,
                        TOOL_MIN_TIME,
                        lambda line: print("phase 5 csrprof " + line))
    torch.cuda.synchronize()
    require(all(torch.isfinite(torch.tensor(list(times.values())))),
            "csrprof: a stage time is not finite")
    return dict(kernels.LAUNCHES), times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 2
    from hashjoin3d_tpu_torch import kernels
    from hashjoin3d_tpu_torch.models.exp1 import Experiment1
    from hashjoin3d_tpu_torch.ops.chaining import build_chaining_host
    from hashjoin3d_tpu_torch.ops.layout import from_numpy_u32
    from hashjoin3d_tpu_torch.ops.strands_windowed import (
        direct_probe_strand_sorted)
    from hashjoin3d_tpu_torch.utils.gen import exp1_data
    from hashjoin3d_tpu_torch.utils.measure import card as card_name

    card = card_name()
    print(card)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.lib()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")

    # phase 1: kernels vs plain versions at the main-path shapes
    rk_np, sa_np, _ = exp1_data(LOG2_R, LOG2_S, False, 0)
    rk, sa = from_numpy_u32(rk_np, dev), from_numpy_u32(sa_np, dev)
    miss_np = np.random.default_rng(0).integers(
        0, (1 << LOG2_R) + (1 << 18), 1 << LOG2_S, dtype=np.uint32)
    wide = from_numpy_u32(miss_np, dev)
    table = build_chaining_host(rk, 1 << LOG2_R, dense_direct=True,
                                n_keys=1 << LOG2_R)
    results = phase1_kernels(rk, sa, dict(table=table, wide_keys=wide))
    check_sort_shapes(dev)
    for name, r in results.items():
        print(f"phase 1 {name}: max_abs_err {r['max_abs_err']}, "
              f"{r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms")
    del table

    # phase 2: the main path, Experiment1 plan Csr on the card
    kernels.reset_launch_counts()
    buf = io.StringIO()
    exp = Experiment1(LOG2_R, LOG2_S, skew=False, t=0, b=1, plans=("Csr",),
                      measure_file=buf, device=dev)
    exp.init()
    exp.run()
    torch.cuda.synchronize()
    after2 = dict(kernels.LAUNCHES)
    ref_hdr, ref = csr_row(REFERENCE_CSV.read_text())
    hdr, row = csr_row(buf.getvalue())
    require(hdr == ref_hdr, "CSV header differs from the reference")
    bad = [(hdr[i], row[i], ref[i]) for i in value_cols(hdr)
           if row[i] != ref[i]]
    require(not bad, f"Csr row differs from the reference: {bad}")
    table_gpu, out_gpu = exp.results["Csr"]
    require(out_gpu["route_worst"] == 0,
            f"route_worst {out_gpu['route_worst']} at the canonical shape")
    rk_cpu, sa_cpu = exp.rk.cpu(), exp.sa.cpu()
    table_cpu = build_chaining_host(rk_cpu, 1 << LOG2_R, dense_direct=True,
                                    n_keys=1 << LOG2_R)
    for f in ("direct", "bucket_len", "bucket_start", "pos_by_row"):
        require(torch.equal(getattr(table_gpu, f).cpu(),
                            getattr(table_cpu, f)),
                f"build: {f} differs from the plain build")
    same_join(out_gpu, direct_probe_strand_sorted(table_cpu, sa_cpu,
                                                  unique=True), "phase 2")
    t_build, t_probe = (int(row[hdr.index(c)])
                        for c in ("t_buildStr", "t_probeStr"))
    print(f"phase 2 Csr R{LOG2_R}/S{LOG2_S} on {card}: t_buildStr {t_build} "
          f"ns, t_probeStr {t_probe} ns, "
          f"{(1 << LOG2_S) / (t_probe * 1e-9) / 1e6:.1f} M probes/s, "
          f"c_htProbe {row[hdr.index('c_htProbe')]}, "
          f"c_htProbeCmp {row[hdr.index('c_htProbeCmp')]}, route_worst 0")
    print("CSV " + buf.getvalue().splitlines()[1])

    # phase 3: Csr probe with misses
    out3 = direct_probe_strand_sorted(table_gpu, wide, unique=True)
    torch.cuda.synchronize()
    after3 = dict(kernels.LAUNCHES)
    same_join(out3, direct_probe_strand_sorted(
        table_cpu, wide.cpu(), unique=True), "phase 3")
    print(f"phase 3 misses: c_htProbe {int(out3['c_htProbe'])}, "
          f"c_htProbeCmp {int(out3['c_htProbeCmp'])}, route_worst "
          f"{out3['route_worst']} (route_nbad {out3['route_nbad']})")

    # phase 4: the paths went through the kernels
    for name in ("bitonic_sort_packed_segmented", "windowed_lookup",
                 "multi_scan"):
        require(after2[name] > 0, f"{name} not launched in phase 2")
    require(after3["bitonic_sort_segmented"] > 0,
            "bitonic_sort_segmented not launched in phase 3")
    print(f"launches after phase 2 {after2}, after phase 3 {after3}")

    # phase 5: K2 and K2b edge cases, safe_lookup's routes on the card, P8,
    # P1-P9, and the measurement tools' path
    from hashjoin3d_tpu_torch.tools.mosaic_probe import PROBES
    results["K2b windowed_lookup db"] = phase5_k2b(table_gpu.direct, exp.sa,
                                                   dev)
    r = results["K2b windowed_lookup db"]
    print(f"phase 5 K2b: bit-equal to K2 (words, bad, nbad) and plain on "
          f"every edge stream at W = {WINDOW} and 32768, at W = 65536, on a "
          f"padded table and on an unaligned key view; {r['ms']:.4f} ms vs "
          f"K2 {r['k2_ms_same_call']:.4f} ms, K2 with coverage "
          f"{r['k2_covered_ms_same_call']:.4f} ms in the same call "
          f"(W = 32768: {r['w32768_ms']:.4f} ms)")
    k2 = results["K2 windowed_lookup"]
    print(f"phase 1 K2 with coverage on {card}: " + json.dumps({
        k: k2[k] for k in ("ms", "k2b_ms_same_call", "library_ms",
                           "bound_ms")}))
    routes = phase5_safe_lookup(table_gpu.direct, exp.sa)
    print(f"phase 5 safe_lookup equal to the CPU run, (route, nbad): "
          f"{routes}")
    p8 = phase5_p8(dev)
    print(f"phase 5 P8 host/device per call on {card}: " + json.dumps(p8))
    phase5_p5(dev)
    print(f"phase 5 P5: bit-equal to its plain version at C = {P5_BLOCKS}")
    phase5_p3_p4(dev)
    print(f"phase 5 P3 axis 0 bit-equal to its plain version at (rows, "
          f"block_rows) {P3_ROW_BLOCKS}; P4 at rows {P4_ROWS}, three "
          f"matrices, x < 2^24 and x = 2^24 - 1")
    k3 = results["K3 multi_scan"]
    print(f"phase 1 K3 on {card}: " + json.dumps({
        k: k3[k] for k in ("ms", "host_us", "device_ms", "reverse_min_ms",
                           "reverse_min_host_us", "reverse_min_device_ms",
                           "library_ms", "bound_ms")}))
    probe_results, probe_tools = phase5_probes(dev)
    print(f"launches on the probe runner's path {probe_tools}")
    del exp, table_gpu, out_gpu, out3
    torch.cuda.empty_cache()
    tools, stage_ms = phase5_tools(dev)
    require(tools["windowed_lookup_db"] > 0,
            "windowed_lookup_db not launched on the tools' path")
    print(f"launches on the tools' path {tools}")
    print("phase 5 csrprof stage 2 on " + card + ": " + json.dumps(
        {k: v for k, v in stage_ms.items() if k.startswith("2")}))

    entries = [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=after2[key],
             miss_probe_launches=after3[key] - after2[key],
             tool_launches=tools[key],
             probe_tool_launches=probe_tools[key], **results[name])
        for name, (src, rep, key) in KERNELS.items()]
    for pid, (_, line, key) in PROBES.items():
        entries.append(dict(
            name=f"{pid} {key}", route="cuda",
            source="hashjoin3d_tpu_torch/csrc/probes.cu",
            replaces=f"tools/mosaic_probe.py:{line}",
            launches=after2[key],
            miss_probe_launches=after3[key] - after2[key],
            tool_launches=tools[key],
            probe_tool_launches=probe_tools[key], **probe_results[pid]))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
