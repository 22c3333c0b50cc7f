#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: exp-1's eleven device
plans and exp-4's three.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It builds the hand-written kernels from ``hashjoin3d_tpu_torch/csrc`` and
drives the port's main path, the reference's headline configuration
(``main_experiment1 -R 20 -S 24 --no-skew -t 0 -b 1``: R.k 2^20 keys, S.a
2^24 foreign keys) under every plan (``all`` and the three *Sel plans),
then exp-4 (``main_experiment4 -R 24 -a 4 -A 4 -b 2 -B 2``: |R| 2^24,
|S| = |T| = 12,582,912).  Phases, any failure exits non-zero:

0. the card and its power limit (``nvidia-smi``), the kernel build time;
1. each kernel against its plain PyTorch version on the same CUDA tensors at
   the main-path shapes, bit-equal: K2 (words, its per-chunk coverage
   flags and their count, as ``safe_lookup`` calls it), K3 (the build's two
   calls, ``expand``'s ("max",) over Nrs's 2^24 output slots, then ragged
   sizes up to 2^24 + 77, four columns, maxpair both
   ways, an unaligned column; its host and device time a call), and the
   radix sorts K1 (keys and
   rows) and K4 (1-op, take_min with an ascending payload, stable with a
   shuffled payload); then K1 and K4 at other segment sizes (256 .. 8192 on
   the one-block path, 2^14 and 2^15 on the multi-tile path) and key
   widths, bit-equal except take_min with a shuffled payload, whose
   equal-key payload order is free (keys equal, each segment's payload a
   permutation that carries its own key);
2. ``Experiment1(20, 24, t=0, plans=all + CsrSel, CrsSel, NrsSel,
   device="cuda")``, the launch counts set to 0 just before each plan:
   every row of ``all``'s plans equals the same plan's row of
   ``artifacts/r5/e1_t0c.csv`` in its value columns (c_*, ht_*,
   parameters); the *Sel rows' c_selProbe, c_htProbe and c_top equal their
   numpy counts; ``route_worst`` is 0 on every join plan; each join plan's
   build fields equal the plain build's on CPU copies (``chain_by_key``,
   the nested ``direct``/``bucket_main_len``, the compacted directories,
   ``main_pos_by_group`` and ``key_direct``) and its counters and result
   pairs (NrsNU: probe row and group key) equal, as a multiset, those of
   the same strand run with the plain versions on the CPU; one line a plan
   with its strand times; then one call of Crs's strand on its sorted
   route (R.k not declared a permutation: K1 sorts it), equal to the
   permutation route's counters and pairs;
3. a Csr probe with misses (2^24 keys, numpy seed 0, over
   [0, 2^20 + 2^18)): counters bit-equal and pairs multiset-equal to the
   CPU plain run; 3b. Crs, Nrs and NrsNU at R20/S24 ``-t 4`` and ``--skew
   -t 0`` (misses, 16 and 256 rows a key, a 1.16M-row hot group; 0.05 s
   minimum time): rows equal to ``e1_t4.csv`` / ``e1_zipf.csv``, route 0,
   NrsNU's c_htProbe and c_htProbeCmp equal Nrs's, builds and pairs equal
   to the CPU run;
4. launch counts: K1, K2 and K3 launched in phase 2's Csr, CsrUU and Nsr,
   K2 and K3 in its Nrs and in each new plan (Crs and the *Sel plans), K4
   in its Crs and CrsSel (their whole-chain walks), K1 on the sorted route
   of Crs's strand, K4 in phase 3 and in phase 3b's Nrs at t=4 (the other
   t=0 plans never miss, so they bypass K4);
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

6. ``Experiment4`` with plans Ndu, Chj and Nnu at ``-R 24 -a 4 -A 4 -b 2
   -B 2`` (the reference's timing protocol) and at ``-R 20`` (0.05 s
   minimum time), the launch counts set to 0 just before each plan: Ndu's
   and Chj's rows equal ``artifacts/r5/e4_24.csv`` / ``e4_20.csv`` in
   every value column, Nnu's c_top equals numFkCommon, ``route_worst`` is
   0; at R20 every plan's counters, result triples (Nnu: its nested
   tuples) equal the CPU run's, as multisets, and K2, K3 and K4 launch in
   each plan (at R24 the probe walks sort globally, with no K4).

Prints one JSON line of per-kernel results, then, last,
``{"ok": true, "device": {...}}``.  ``launches`` there is the main path's
count (phase 2's plans summed), ``plan_launches`` each plan's, phase 3b's
runs under "Nrs t=4" and the like, phase 6's under "Ndu R24" and the
like, the sorted-route call under "Crs sorted route";
``miss_probe_launches`` is phase 3's, ``probe_tool_launches`` phase 5's
probe runner's (its check and timed launches) and ``tool_launches`` phase
5's roofline and csrprof path's.
``bound_ms`` is the kernel's bytes
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
#: the plans phase 2 runs, in the harness's order; the *Sel plans have no
#: reference row
PLANS = ("scr", "scs", "Csr", "CsrUU", "Crs", "Nsr", "Nrs", "NrsNU",
         "CsrSel", "CrsSel", "NrsSel")
SEL_PLANS = ("CsrSel", "CrsSel", "NrsSel")
REF_PLANS = tuple(p for p in PLANS if p not in SEL_PLANS)
#: phase 3b's runs with misses: (label, Experiment1 arguments, reference)
MISS_RUNS = (("t=4", dict(skew=False, t=4),
              REPO / "artifacts" / "r5" / "e1_t4.csv"),
             ("zipf", dict(skew=True, t=0),
              REPO / "artifacts" / "r5" / "e1_zipf.csv"))
MISS_PLANS = ("Crs", "Nrs", "NrsNU")
MISS_MIN_TIME = 0.05
#: each join plan's build fields held against the plain build on the CPU
_GROUP_FIELDS = ("key_direct", "groups.ukey", "groups.group_start",
                 "groups.group_len", "groups.group_rows", "groups.first_row",
                 "groups.n_keys")
_NESTED_FIELDS = ("main_pos_by_group", "bucket_main_len", *_GROUP_FIELDS)
BUILD_FIELDS = {
    "Csr": ("direct", "bucket_len", "bucket_start", "pos_by_row"),
    "CsrUU": ("direct", "bucket_len", "bucket_start", "pos_by_row",
              "chain_by_key"),
    "Crs": ("bucket_len", "bucket_start", *_GROUP_FIELDS),
    "Nsr": ("direct", "bucket_main_len"),
    "Nrs": _NESTED_FIELDS,
}
#: plans whose build is another plan's (one CPU build serves both)
SAME_BUILD = {"NrsNU": "Nrs", "NrsSel": "Nrs", "CsrSel": "Csr",
              "CrsSel": "Crs"}
#: phase 6's exp-4 runs: (label, -R, reference CSV, minimum time)
EXP4_RUNS = (("R24", 24, REPO / "artifacts" / "r5" / "e4_24.csv", 0.3),
             ("R20", 20, REPO / "artifacts" / "r5" / "e4_20.csv", 0.05))
EXP4_PARAMS = dict(alpha=4, mult_alpha=4, beta=2, mult_beta=2)
EXP4_PLANS = ("Ndu", "Chj", "Nnu")
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


def expand_heads(sa):
    """The column ``expand`` scans with ("max",) in plan Nrs at R20/S24
    t=0: 2^24 output slots, each group's rank at its first slot, -1
    elsewhere (groups = S.a's keys in key order, as the permutation
    probes of R.k give them)."""
    from hashjoin3d_tpu_torch.ops.layout import I32

    counts = torch.bincount(sa.long(), minlength=1 << LOG2_R).to(I32)
    off = torch.cumsum(counts, 0, dtype=I32) - counts
    rank = torch.arange(counts.shape[0], dtype=I32, device=sa.device)
    heads = torch.full((sa.shape[0],), -1, dtype=I32, device=sa.device)
    live = counts > 0
    heads[off[live].long()] = rank[live]
    return heads


def k3_cases(fwd, nxt, heads, gen):
    """(label, columns, ops, reverse) of phase 1's K3 checks: the build's
    two calls; ``expand``'s ("max",) over 2^24 slots; (sum, max) both ways
    over full-range columns at 1, one tile - 1, one tile + 1, three tiles
    + 77 and 2^24 + 77 elements; four
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
           ("build", (nxt,), ("min",), True),
           ("expand", (heads,), ("max",), False)]
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
    heads = expand_heads(sa)
    for what, cols, op, rev in k3_cases(fwd, nxt, heads, gen):
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
        expand_max_ms=cuda_ms(lambda: scan.multi_scan((heads,), ("max",))),
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


def plan_rows(text):
    """(header, {plan: row}) of an exp-1 CSV."""
    rows = list(csv.reader(io.StringIO(text), delimiter=";"))
    return rows[0], {r[9]: r for r in rows[1:]}


def check_rows(text, ref_path, plans, what):
    """Each plan's row equal to the reference's in every value column; the
    scan plans' rows are one field short (no ``reps``) on both sides."""
    hdr, rows = plan_rows(text)
    ref_hdr, ref = plan_rows(ref_path.read_text())
    require(hdr == ref_hdr, f"{what}: CSV header differs from the reference")
    for plan in plans:
        row, want = rows[plan], ref[plan]
        require(len(row) == len(want), f"{what} {plan}: {len(row)} fields, "
                f"the reference {len(want)}")
        bad = [(hdr[i], row[i], want[i]) for i in value_cols(hdr)
               if i < len(row) and row[i] != want[i]]
        require(not bad, f"{what} {plan}: row differs from the reference "
                f"{ref_path.name}: {bad}")
    return hdr, rows


def pairs_multiset_key(out: dict) -> torch.Tensor:
    """A strand's hit pairs as one sorted int64 column
    (probe_row << 32 | build_row): equal multisets give equal columns."""
    hit = out["probe_row"] >= 0
    packed = (out["probe_row"][hit].to(torch.int64) * (1 << 32)
              + out["build_row"][hit].to(torch.int64))
    return torch.sort(packed).values


def same_join(got, want, what):
    for k in ("c_htProbe", "c_htProbeCmp", "total", "c_selProbe"):
        if k not in want:
            continue
        require(int(got[k]) == int(want[k]),
                f"{what}: {k} {int(got[k])} != plain {int(want[k])}")
    require(torch.equal(pairs_multiset_key(got).cpu(),
                        pairs_multiset_key(want).cpu()),
            f"{what}: result pairs differ from the plain run")


def field(table, name: str):
    for part in name.split("."):
        table = getattr(table, part)
    return table


def run_plans(exp, plans) -> dict:
    """The CSV header, then each plan's row with the launch counts set to
    0 just before it: {plan: counts after it}."""
    from hashjoin3d_tpu_torch import kernels

    launches = {}
    exp.write_header()
    for plan in plans:
        kernels.reset_launch_counts()
        exp.run_plan(plan)
        torch.cuda.synchronize()
        launches[plan] = dict(kernels.LAUNCHES)
    return launches


def nested_pairs_key(out: dict, table) -> torch.Tensor:
    """NrsNU's nested tuples as one sorted int64 column
    (probe_row << 32 | group key)."""
    hit = out["nested_hit"]
    ukey = table.groups.ukey[out["nested_g"][hit].long()]
    packed = (out["nested_probe_row"][hit].to(torch.int64) * (1 << 32)
              + (ukey.to(torch.int64) & 0xFFFFFFFF))
    return torch.sort(packed).values


def check_against_cpu(exp, exp_cpu, plans, what):
    """Each plan's build and strand output on the card equal to the same
    build and strand run with the plain versions on CPU copies of the
    inputs: build fields bit-equal, counters equal, result pairs (NrsNU:
    probe row and group key) equal as multisets.  Plans with the same
    build share one CPU build (``SAME_BUILD``)."""
    cpu_tables = {}
    for plan in plans:
        table, out = exp.results[plan]
        jp = exp_cpu.join_plan(plan)
        build = SAME_BUILD.get(plan, plan)
        if build not in cpu_tables:
            cpu_tables[build] = jp.build(jp.build_keys)
        tcpu = cpu_tables[build]
        for f in BUILD_FIELDS[build]:
            require(torch.equal(field(table, f).cpu(), field(tcpu, f)),
                    f"{what} {plan}: build field {f} differs from the "
                    "plain build")
        ocpu = jp.probe(tcpu, jp.probe_keys)
        if plan == "NrsNU":
            for k in ("c_htProbe", "c_htProbeCmp", "c_top"):
                require(int(out[k]) == int(ocpu[k]), f"{what} {plan}: {k} "
                        f"{int(out[k])} != plain {int(ocpu[k])}")
            require(torch.equal(nested_pairs_key(out, table).cpu(),
                                nested_pairs_key(ocpu, tcpu)),
                    f"{what} {plan}: nested tuples differ from the plain run")
        else:
            same_join(out, ocpu, f"{what} {plan}")
            if "c_unnest" in ocpu:
                require(int(out["c_unnest"]) == int(ocpu["c_unnest"]),
                        f"{what} {plan}: c_unnest differs from the plain run")
        del ocpu
    del cpu_tables


def plan_line(hdr, row, what, card) -> str:
    """One printed line a plan: its strand times and the card."""
    col = {c: row[i] for i, c in enumerate(hdr[:len(row)])}
    if row[9] in ("scr", "scs"):  # no reps field: t_total sits at reps
        col = {c: row[i] for i, c in enumerate(
            [c for c in hdr if c != "reps"])}
        return (f"{what} {row[9]} on {card}: t_total {col['t_total']} ns, "
                f"t_buildStr NA, t_probeStr NA, c_top {col['c_top']}")
    probes = int(col["c_scanProbe"])
    t_probe = int(col["t_probeStr"])
    return (f"{what} {row[9]} on {card}: t_buildStr {col['t_buildStr']} ns, "
            f"t_probeStr {t_probe} ns, "
            f"{probes / (t_probe * 1e-9) / 1e6:.1f} M probes/s, reps "
            f"{col['reps']}, c_selProbe {col['c_selProbe']}, c_htProbe "
            f"{col['c_htProbe']}, c_htProbeCmp "
            f"{col['c_htProbeCmp']}, c_unnest {col['c_unnest']}, c_top "
            f"{col['c_top']}")


def phase3b_misses(dev, card):
    """Crs, Nrs and NrsNU at R20/S24 t=4 and under zipf (misses, 16-256
    rows a key, a 1.16M-row hot group): rows equal to the reference's,
    route 0,
    NrsNU's shared counters equal Nrs's, card equal to the CPU run; the
    launch counts of each plan from 0."""
    from hashjoin3d_tpu_torch.models.exp1 import Experiment1

    launches = {}
    for label, kw, ref in MISS_RUNS:
        buf = io.StringIO()
        exp = Experiment1(LOG2_R, LOG2_S, b=1, plans=MISS_PLANS,
                          measure_file=buf, min_runtime_s=MISS_MIN_TIME,
                          device=dev, **kw)
        exp.init()
        counts = run_plans(exp, MISS_PLANS)
        hdr, rows = check_rows(buf.getvalue(), ref, MISS_PLANS,
                               f"phase 3b {label}")
        for k in ("c_htProbe", "c_htProbeCmp"):
            i = hdr.index(k)
            require(rows["NrsNU"][i] == rows["Nrs"][i],
                    f"phase 3b {label}: NrsNU's {k} differs from Nrs's")
        for plan in MISS_PLANS:
            require(exp.results[plan][1]["route_worst"] == 0,
                    f"phase 3b {label} {plan}: route_worst "
                    f"{exp.results[plan][1]['route_worst']}")
            launches[f"{plan} {label}"] = counts[plan]
            print(plan_line(hdr, rows[plan], f"phase 3b {label}", card))
        exp_cpu = Experiment1(LOG2_R, LOG2_S, b=1, plans=MISS_PLANS,
                              device="cpu", trace=False, **kw)
        exp_cpu.init()
        check_against_cpu(exp, exp_cpu, MISS_PLANS, f"phase 3b {label}")
        del exp, exp_cpu
        torch.cuda.empty_cache()
    return launches


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


def check_sel_rows(hdr, rows, rk_np, sa_np):
    """The *Sel rows' c_selProbe, c_htProbe and c_top against numpy counts
    of filter-then-join at R20/S24 t=0: CsrSel keeps S.a < 2^19 (every one
    hits R), CrsSel and NrsSel keep R.k < 2^19 (CrsSel matches each S row
    of those keys, NrsSel each distinct key once and unnests its rows)."""
    half = 1 << (LOG2_R - 1)
    sel_s = sa_np[sa_np < half]
    want = {"CsrSel": (sel_s.size, sel_s.size, sel_s.size),
            "CrsSel": (int((rk_np < half).sum()), sel_s.size, sel_s.size),
            "NrsSel": (int((rk_np < half).sum()), np.unique(sel_s).size,
                       sel_s.size)}
    for plan, counts in want.items():
        got = tuple(int(rows[plan][hdr.index(k)])
                    for k in ("c_selProbe", "c_htProbe", "c_top"))
        require(got == counts, f"phase 2 {plan}: (c_selProbe, c_htProbe, "
                f"c_top) {got}, numpy {counts}")


def phase2_sorted_route(exp):
    """Crs's strand on its sorted route: R.k not declared a permutation,
    so ``_sort_probes`` sorts it (K1 over 2^18-key segments); counters and
    pairs equal the permutation route's.  The four sorted segments each
    restart the expansion's row stream, and its window (8192, the cap)
    keeps no margin there, so a few boundary chunks take the patched route
    (1, exact), as the same call does on the CPU.  Returns the call's
    launch counts, from 0, and its (route, nbad)."""
    from hashjoin3d_tpu_torch import kernels
    from hashjoin3d_tpu_torch.ops.strands_windowed import (
        keydirect_chaining_strand_sorted)

    table, out = exp.results["Crs"]
    kernels.reset_launch_counts()
    got = keydirect_chaining_strand_sorted(table, exp.rk, 1 << LOG2_S)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    same_join(got, out, "phase 2 Crs sorted route")
    require(got["route_worst"] <= 1, f"phase 2 Crs sorted route: "
            f"route_worst {got['route_worst']}")
    require(launches["bitonic_sort_packed_segmented"] > 0,
            "bitonic_sort_packed_segmented not launched on Crs's sorted "
            "route")
    return launches, (got["route_worst"], got["route_nbad"])


def triples_key(out: dict) -> torch.Tensor:
    """An exp-4 strand's result triples as one sorted int64 column
    (r << 42 | s << 21 | t; rows below 2^21 at R20)."""
    live = out["r_row"] >= 0
    r, s, t = (out[k][live].to(torch.int64) for k in ("r_row", "s_row",
                                                       "t_row"))
    return torch.sort((r << 42) | (s << 21) | t).values


def exp4_line(hdr, row, what, card) -> str:
    col = dict(zip(hdr, row))
    return (f"{what} {row[10]} on {card}: t_build_S {col['t_build_S']} ns, "
            f"t_build_T {col['t_build_T']} ns, t_probe_R {col['t_probe_R']}"
            f" ns, reps {col['reps']}, c_probe_RS {col['c_probe_RS']}, "
            f"c_probe_RS_cmp {col['c_probe_RS_cmp']}, c_probe_RT "
            f"{col['c_probe_RT']}, c_probe_RT_cmp {col['c_probe_RT_cmp']}, "
            f"c_top {col['c_top']}")


def phase6_exp4(dev, card):
    """Ndu, Chj and Nnu at R24 and R20 (``EXP4_RUNS``), the launch counts
    set to 0 just before each plan: Ndu's and Chj's rows equal the
    reference's in every value column, Nnu's c_top is numFkCommon, route
    0; at R20 counters, triples and Nnu's nested tuples equal the CPU
    run's, and K2, K3 and K4 launch in every plan."""
    from hashjoin3d_tpu_torch import kernels
    from hashjoin3d_tpu_torch.models.exp4 import Experiment4

    launches = {}
    for label, log2_r, ref, min_time in EXP4_RUNS:
        buf = io.StringIO()
        exp = Experiment4(log2_r, **EXP4_PARAMS, plans=EXP4_PLANS,
                          measure_file=buf, min_runtime_s=min_time,
                          device=dev)
        exp.init()
        exp.write_header()
        for plan in EXP4_PLANS:
            kernels.reset_launch_counts()
            exp.run_plan(plan)
            torch.cuda.synchronize()
            launches[f"{plan} {label}"] = dict(kernels.LAUNCHES)
        rows = list(csv.reader(io.StringIO(buf.getvalue()), delimiter=";"))
        hdr, got = rows[0], {r[10]: r for r in rows[1:]}
        ref_rows = list(csv.reader(io.StringIO(ref.read_text()),
                                   delimiter=";"))
        require(ref_rows[0] == hdr, f"phase 6 {label}: CSV header differs")
        keep = [i for i, c in enumerate(hdr) if c.startswith(("c_", "card"))
                or c in ("plan", "ht_impl", "log2CardR", "a", "aM", "b",
                         "bM")]
        for want in ref_rows[1:]:
            bad = [(hdr[i], got[want[10]][i], want[i]) for i in keep
                   if got[want[10]][i] != want[i]]
            require(not bad, f"phase 6 {label} {want[10]}: row differs from "
                    f"{ref.name}: {bad}")
        require(int(got["Nnu"][hdr.index("c_top")]) == exp.num_fk_common,
                f"phase 6 {label} Nnu: c_top is not numFkCommon")
        for plan in EXP4_PLANS:
            route = exp.results[plan][2]["route_worst"]
            require(route == 0, f"phase 6 {label} {plan}: route_worst "
                    f"{route}")
            print(exp4_line(hdr, got[plan], f"phase 6 {label}", card))
            print("CSV " + ";".join(got[plan]))
        if log2_r == 20:
            check_exp4_against_cpu(exp, launches, label)
        del exp
        torch.cuda.empty_cache()
    return launches


def check_exp4_against_cpu(exp, launches, label):
    """Each plan's strand on the CPU (plain versions) over CPU copies of
    the inputs and builds: counters equal, triples (Nnu: nested tuples)
    equal as multisets; K2, K3 and K4 launched in every plan's run."""
    from hashjoin3d_tpu_torch.models.exp4 import Experiment4

    cpu = Experiment4(exp.log2_card_r, **EXP4_PARAMS, plans=EXP4_PLANS,
                      device="cpu", trace=False)
    cpu.init()
    for plan in EXP4_PLANS:
        _, _, out = exp.results[plan]
        ocpu = cpu.probe(plan, cpu.build(plan, cpu.sa),
                         cpu.build(plan, cpu.ta), cpu.rk)
        for k, v in ocpu.items():
            if k.startswith("c_"):
                require(int(out[k]) == int(v), f"phase 6 {label} {plan}: {k} "
                        f"{int(out[k])} != plain {int(v)}")
        if plan == "Nnu":
            for k in ("g_s", "g_t"):
                require(torch.equal(out[k].cpu(), ocpu[k]),
                        f"phase 6 {label} Nnu: {k} differs from the CPU run")
        else:
            require(torch.equal(triples_key(out).cpu(), triples_key(ocpu)),
                    f"phase 6 {label} {plan}: triples differ from the CPU "
                    "run")
        for name in ("windowed_lookup", "multi_scan",
                     "bitonic_sort_segmented"):
            require(launches[f"{plan} {label}"][name] > 0,
                    f"{name} not launched in phase 6's {plan} {label}")


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

    # phase 2: the main path, Experiment1's eleven plans on the card, the
    # launch counts set to 0 just before each plan
    buf = io.StringIO()
    exp = Experiment1(LOG2_R, LOG2_S, skew=False, t=0, b=1, plans=PLANS,
                      measure_file=buf, device=dev)
    exp.init()
    plan_launches = run_plans(exp, PLANS)
    hdr, rows = check_rows(buf.getvalue(), REFERENCE_CSV, REF_PLANS,
                           "phase 2")
    check_sel_rows(hdr, rows, rk_np, sa_np)
    for plan in PLANS[2:]:
        route = exp.results[plan][1]["route_worst"]
        require(route == 0, f"phase 2 {plan}: route_worst {route} at the "
                "canonical shape")
    for plan in PLANS:
        print(plan_line(hdr, rows[plan], f"phase 2 R{LOG2_R}/S{LOG2_S} t=0",
                        card))
    for plan in PLANS:
        print("CSV " + ";".join(rows[plan]))
    exp_cpu = Experiment1(LOG2_R, LOG2_S, skew=False, t=0, b=1, plans=PLANS,
                          device="cpu", trace=False)
    exp_cpu.init()
    check_against_cpu(exp, exp_cpu, PLANS[2:], "phase 2")
    sorted_route, route = phase2_sorted_route(exp)
    print("phase 2 Crs sorted route (K1): counters and pairs equal the "
          f"permutation route's; (route, nbad) {route}")
    table_gpu, out_gpu = exp.results["Csr"]
    table_cpu = exp_cpu.join_plan("Csr").build(exp_cpu.rk)
    after2 = {k: sum(c[k] for c in plan_launches.values())
              for k in kernels.LAUNCHES}

    # phase 3: Csr probe with misses
    kernels.reset_launch_counts()
    out3 = direct_probe_strand_sorted(table_gpu, wide, unique=True)
    torch.cuda.synchronize()
    after3 = dict(kernels.LAUNCHES)
    same_join(out3, direct_probe_strand_sorted(
        table_cpu, wide.cpu(), unique=True), "phase 3")
    print(f"phase 3 misses: c_htProbe {int(out3['c_htProbe'])}, "
          f"c_htProbeCmp {int(out3['c_htProbeCmp'])}, route_worst "
          f"{out3['route_worst']} (route_nbad {out3['route_nbad']})")
    del exp_cpu, table_cpu

    # phase 3b: Crs, Nrs and NrsNU at t=4 and under zipf
    miss_launches = phase3b_misses(dev, card)

    # phase 4: the paths went through the kernels
    need = {"Csr": ("bitonic_sort_packed_segmented", "windowed_lookup",
                    "multi_scan"),
            "Nrs": ("windowed_lookup", "multi_scan"),
            "Crs": ("windowed_lookup", "multi_scan",
                    "bitonic_sort_segmented")}
    need["CsrUU"] = need["Nsr"] = need["Csr"]
    need["CsrSel"] = need["NrsSel"] = need["Nrs"]
    need["CrsSel"] = need["Crs"]
    for plan, names in need.items():
        for name in names:
            require(plan_launches[plan][name] > 0,
                    f"{name} not launched in phase 2's {plan}")
    require(after3["bitonic_sort_segmented"] > 0,
            "bitonic_sort_segmented not launched in phase 3")
    for run in ("Nrs t=4", "Crs t=4"):
        require(miss_launches[run]["bitonic_sort_segmented"] > 0,
                f"bitonic_sort_segmented not launched in phase 3b's {run}")
    plan_launches.update(miss_launches)
    plan_launches["Crs sorted route"] = sorted_route
    for plan, counts in plan_launches.items():
        print(f"launches {plan}: " + json.dumps(
            {k: v for k, v in counts.items() if v}))
    print(f"launches after phase 3 {after3}")

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

    # phase 6: exp-4's plans at R24 and R20
    t6 = time.perf_counter()
    exp4_launches = phase6_exp4(dev, card)
    print(f"phase 6: {time.perf_counter() - t6:.1f} s; smoke so far "
          f"{time.perf_counter() - t0:.1f} s")
    plan_launches.update(exp4_launches)
    for plan, counts in exp4_launches.items():
        print(f"launches {plan}: " + json.dumps(
            {k: v for k, v in counts.items() if v}))

    entries = [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=after2[key],
             plan_launches={p: c[key] for p, c in plan_launches.items()},
             miss_probe_launches=after3[key],
             tool_launches=tools[key],
             probe_tool_launches=probe_tools[key], **results[name])
        for name, (src, rep, key) in KERNELS.items()]
    for pid, (_, line, key) in PROBES.items():
        entries.append(dict(
            name=f"{pid} {key}", route="cuda",
            source="hashjoin3d_tpu_torch/csrc/probes.cu",
            replaces=f"tools/mosaic_probe.py:{line}",
            launches=after2[key],
            plan_launches={p: c[key] for p, c in plan_launches.items()},
            miss_probe_launches=after3[key],
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
