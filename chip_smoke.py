#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: exp-1's eleven device
plans, exp-4's three, ``join``, the one-call API, the algebra, out-of-core
streaming and the host engine.

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

7. ``hashjoin3d_tpu_torch.join``, the one-call API, on the same R20/S24
   t=0 columns: ``join(R.k, S.a, how="chaining", unique=True)``,
   ``join(R.k, S.a, how="chaining")``, ``join(R.k, S.a)``,
   ``join(S.a, R.k, how="chaining")`` and ``join(S.a, R.k)`` give the
   counters of e1_t0c.csv's Csr, CsrUU, Nsr, Crs and Nrs rows; the same
   five on u64 keys (``k | 0xAB << 40``), the Nrs-shaped call on composite
   keys (``pack2u32(k >> 10, k & 1023)``) and the Crs-shaped one on sparse
   u32 keys (``murmur32(k)``) give the u32 calls' pairs, and, at R18/S22,
   counters and pairs equal to the plain run on the CPU (with the u64
   Nrs-shaped call under ``hashfun="fib"``); left, semi and anti on the
   Nrs-shaped u32 and u64 inputs derive from the inner join's hit set
   with its counters; a post predicate equals numpy's filter of the inner
   pairs; ``fib`` on the u64 Nrs-shaped call keeps its pairs; K1-K4 all
   launch.  Each call prints its wall ms (median of 3, host work, sizing
   read and copy to the host included), ``route_worst`` and its launch
   counts from 0; then ``lookup_auto``'s two methods timed on the semi
   path's probe.

8. The clarity layer and the algebra (``models/algebra.py``), each plan's
   launch counts from 0 (``algebra_launches`` in the kernels line): 8a.
   six plans at R20/S24 t=0 through ``Relation`` and the operators,
   interpreted (Csr, CsrUU and Crs on ``AlgHashJoinBuild`` /
   ``AlgHashJoinProbe``, Nsr and Nrs on ``AlgNestJoinBuild`` /
   ``AlgNestJoinProbe`` / ``AlgUnnestHt``, NrsNU without the unnest):
   the probe's count and ``num_cmps``, the unnest's and the top's counts
   equal ``e1_t0c.csv``, the result pairs (NrsNU: probe row and group key)
   the windowed strand's as multisets; a seventh plan with ``k < |R| /
   2`` under the Csr build (the masked build) equals numpy; each plan's
   ``print_strand``; 8b. ``compile_strand`` on Csr, Nsr and Nrs: counters
   and pairs equal the interpreted run's, a half-size capacity raises,
   host reads (``cudaStreamSynchronize``) and wall ms of both runs; 8c.
   ``Experiment1`` Csr, CsrUU and Nsr with R.k declared not dense (the
   clarity strands): rows equal ``e1_t0c.csv``, pairs the windowed
   strands', route 0; 8d. exp-4's clarity strands (Ndu, Chj, Nnu) at R24
   on ``build_nested`` / ``build_chaining`` tables: counters equal
   ``e4_24.csv`` (Nnu: the sorted strand's), triples the sorted strands'
   as multisets, and both strands' ms; 8e. ``algebra_example``'s four
   queries on the card equal the goldens of ``tests/test_algebra.py``;
   8f. ``hash_aggregate`` (masked, with an ``n_keys`` hint),
   ``radix_partition`` (both ways) and ``compact`` over S.a's 2^24 rows
   equal numpy.  K2 and K3 must launch in every join plan of 8a, 8c and
   8d.

9. Out-of-core streaming (``ops/streaming.py``: the probe column on the
   host, uploaded chunk by chunk through pinned buffers on a side stream),
   each stream's launch counts from 0 (``stream_launches`` in the kernels
   line): 9a. Csr, Nsr (2^24 S probes, 3 x 2^20-row chunks) and Crs,
   Nrs (2^20 R probes, 3 x 2^18-row chunks) through tables built on the
   card: counters equal ``e1_t0c.csv``, pairs (``collect_pairs``) the
   whole-column strand's as multisets; 9b. the merged streams (u64
   Nrs- and Csr-shaped, sparse u32 Crs-shaped) and 9c. a dense-direct
   ``fib`` Csr stream at R18/S22 equal the same streams on the CPU; 9d.
   ``tools/oocbench.py`` at 2^25 and 2^27 host probes (a 2^20-key
   dense-direct chaining table, a 2^24-row nested table over the same
   domain, 2^22-key chunks): counters equal its numpy model, the peak
   device memory of each stream at 2^27 equals that at 2^25 within one
   chunk's working set, and at 2^27 the streamed probes/s, copy-only,
   probe-only and streamed ms, the profiled split (uploads, probes, their
   overlap, idle share) and the upload rate print.  K1, K2 and K3 must
   launch in phase 9.

10. The host engine (``hostengine.py``, the port's own
   ``native/hj3engine.cpp`` built with ``g++``): 10a. exp-1 ``all`` with
   ``backend="host"`` at R20/S24 t=0 (one rep a plan): rows equal
   ``e1_t0c.csv`` in c_* and ht_*; 10b. exp-4's Ndu and Chj on the host at
   R20 equal ``e4_20.csv``; 10c. ``join`` on both backends at |R| + |S| =
   17 x 2^R for R = 8, 9, .. 20 (R:S 1:16), equal counters, the median wall ms
   of 3 each; 10d. exp-1 (Csr, Nrs; R10-R18) and exp-4 (Ndu, Chj;
   R12-R18) on both backends; then the three crossovers (the smallest row
   volume from which the device beats the host engine at every larger
   size measured) that set the ``HOST_CROSSOVER_ROWS`` of ``api.py``,
   ``models/exp1.py`` and ``models/exp4.py``.

Phases 9 and 10 alone: a driver in a gitignored directory that imports
``chip_smoke``, calls ``kernels.lib()`` and then ``phase9(dev, card)`` /
``phase10(dev, card)``.

Prints one JSON line of per-kernel results, then, last,
``{"ok": true, "device": {...}}``.  ``launches`` there is the main path's
count (phase 2's plans summed), ``plan_launches`` each plan's, phase 3b's
runs under "Nrs t=4" and the like, phase 6's under "Ndu R24" and the
like, the sorted-route call under "Crs sorted route"; ``join_launches``
each phase 7 call's (its first call, from 0), ``algebra_launches`` each
phase 8 plan's (where the kernel launched), ``stream_launches`` each
phase 9 stream's;
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
    strands = roofline.run_rows(roofline.strand_rows(d), TOOL_MIN_TIME,
                                False, log)
    log(f"u64 merged / u32 keydirect nested strand: "
        f"{roofline.strand_ratio(strands):.3f} (the JAX design's bar: <= 2)")
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


#: phase 7's five u32 calls: (label, build side, probe side, join
#: arguments, e1_t0c.csv plan whose counters they reproduce)
JOIN_CALLS = (("Csr", "R", "S", dict(how="chaining", unique=True), "Csr"),
              ("CsrUU", "R", "S", dict(how="chaining"), "CsrUU"),
              ("Nsr", "R", "S", dict(), "Nsr"),
              ("Crs", "S", "R", dict(how="chaining"), "Crs"),
              ("Nrs", "S", "R", dict(), "Nrs"))
#: the hi bits of phase 7's u64 keys
U64_HI = np.uint64(0xAB << 40)
#: the scale of phase 7's CPU comparisons (R18/S22: the plain versions on
#: the CPU stay inside the phase's budget)
CPU_LOG2_R, CPU_LOG2_S = 18, 22
JOIN_KERNELS = ("bitonic_sort_packed_segmented", "windowed_lookup",
                "multi_scan", "bitonic_sort_segmented")


def key_maps():
    """Phase 7's key columns from the u32 ones: u64 with 0xAB << 40 set,
    composite (k >> 10, k & 1023), sparse u32 murmur32(k); each a
    bijection, so every join keeps the u32 join's pairs."""
    from hashjoin3d_tpu_torch import pack2u32
    from hashjoin3d_tpu_torch.ops.hashing import murmur32_np

    return {"u64": lambda k: k.astype(np.uint64) | U64_HI,
            "composite": lambda k: pack2u32(k >> 10, k & 1023),
            "sparse u32": murmur32_np}


def merged_calls():
    """(label, key map, call label it mirrors): the five calls on u64 keys,
    the Nrs-shaped call on composite keys, the Crs-shaped one on sparse
    u32 keys."""
    out = [(f"{label} u64", "u64", label) for label, *_ in JOIN_CALLS]
    return out + [("Nrs composite", "composite", "Nrs"),
                  ("Crs sparse u32", "sparse u32", "Crs")]


def rows_key(probe_rows, build_rows, dev) -> torch.Tensor:
    """Row-id pairs as one sorted int64 column on ``dev``: equal multisets
    give equal columns."""
    p = torch.from_numpy(np.asarray(probe_rows)).to(dev).to(torch.int64)
    b = torch.from_numpy(np.asarray(build_rows)).to(dev).to(torch.int64)
    return torch.sort(p * (1 << 32) + b).values


def join_pairs_key(res, dev) -> torch.Tensor:
    """A JoinResult's pairs as :func:`rows_key`."""
    return rows_key(res.probe_rows, res.build_rows, dev)


def timed_join(args, kw, dev, label, launches):
    """One join with the launch counts from 0 (``launches[label]``), then
    the median wall ms of three more (each ending in its copy to the host,
    which syncs)."""
    from hashjoin3d_tpu_torch import join, kernels

    kernels.reset_launch_counts()
    res = join(*args, device=dev, **kw)
    torch.cuda.synchronize()
    launches[label] = dict(kernels.LAUNCHES)
    times = []
    for _ in range(3):
        t = time.perf_counter()
        join(*args, device=dev, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return res, float(np.median(times))


def launched(counts) -> dict:
    """The kernels of a launch-count snapshot that launched."""
    return {k: v for k, v in counts.items() if v}


def join_line(label, res, ms, launches, card) -> str:
    return (f"phase 7 join {label} on {card}: {ms:.3f} ms (median of 3), "
            f"num_matches {res.num_matches}, num_cmps {res.num_cmps}, "
            f"num_results {res.num_results}, route_worst {res.route_worst} "
            f"(route_nbad {res.route_nbad}), "
            f"launches {json.dumps(launched(launches[label]))}")


def phase7_cpu_counters(dev, maps):
    """The merged calls and the fib call at R18/S22 on the card and with
    the plain versions on the CPU: counters and pairs equal."""
    from hashjoin3d_tpu_torch import join
    from hashjoin3d_tpu_torch.utils.gen import exp1_data

    rk, sa, _ = exp1_data(CPU_LOG2_R, CPU_LOG2_S, False, 0)
    sides = {"R": rk, "S": sa}
    calls = {label: (b, p, kw) for label, b, p, kw, _ in JOIN_CALLS}
    cases = [(label, maps[kind], *calls[base])
             for label, kind, base in merged_calls()]
    cases.append(("Nrs u64 fib", maps["u64"], "S", "R", dict(hashfun="fib")))
    for label, kmap, b, p, kw in cases:
        args = (kmap(sides[b]), kmap(sides[p]))
        got = join(*args, device=dev, **kw)
        want = join(*args, device="cpu", **kw)
        for k in ("num_matches", "num_cmps", "num_results"):
            require(getattr(got, k) == getattr(want, k),
                    f"phase 7 {label} at R{CPU_LOG2_R}/S{CPU_LOG2_S}: {k} "
                    f"{getattr(got, k)} != the CPU run's {getattr(want, k)}")
        require(torch.equal(join_pairs_key(got, dev).cpu(),
                            join_pairs_key(want, "cpu")),
                f"phase 7 {label} at R{CPU_LOG2_R}/S{CPU_LOG2_S}: pairs "
                "differ from the CPU run")
        print(f"phase 7 {label} at R{CPU_LOG2_R}/S{CPU_LOG2_S} (the CPU "
              f"check's scale): counters and pairs equal the CPU run "
              f"(num_cmps {got.num_cmps})")


def phase7_lookup_methods(dev, sides, card):
    """``lookup_auto``'s two methods on the semi path's probe, timed on
    CUDA events: the Nrs-shaped probe (2^20 keys into S.a's 2^20-key
    directory) and the Nsr-shaped one (2^24 keys into R.k's), u32 and
    u64, each held equal to the other."""
    from hashjoin3d_tpu_torch.ops.layout import key_column, widen_u64
    from hashjoin3d_tpu_torch.ops.nested import build_nested_host, probe_nested

    out = {}
    for shape, b, p in (("Nrs", "S", "R"), ("Nsr", "R", "S")):
        for width in ("u32", "u64"):
            bt, pt = key_column(sides[b], dev), key_column(sides[p], dev)
            if width == "u64":
                bt, pt = widen_u64(bt), widen_u64(pt)
            table = build_nested_host(bt, 1 << LOG2_R)
            res = {m: probe_nested(table, pt, method=m)
                   for m in ("search", "merge")}
            for k in ("hit", "group_len"):
                require(torch.equal(getattr(res["search"], k),
                                    getattr(res["merge"], k)),
                        f"phase 7 lookup {shape} {width}: {k} differs "
                        "between search and merge")
            ms = {m: cuda_ms(lambda m=m: probe_nested(table, pt, method=m),
                             reps=5) for m in ("search", "merge")}
            out[f"{shape} {width}"] = ms
            print(f"phase 7 lookup_auto on the semi path, {shape} {width} on "
                  f"{card}: search {ms['search']:.4f} ms, merge "
                  f"{ms['merge']:.4f} ms (probe_nested, events)")
            del table, res
    return out


def phase7_join(dev, card, rk_np, sa_np):
    """``join`` on the card: the five u32 calls against e1_t0c.csv, the
    merged calls (u64, composite, sparse u32) against the u32 calls'
    pairs and the CPU run's counters, the modes, a post predicate, fib,
    and the lookup methods.  Returns each call's launch counts, from 0."""
    from hashjoin3d_tpu_torch import join

    t7 = time.perf_counter()
    ref = plan_rows(REFERENCE_CSV.read_text())
    hdr, ref_rows = ref
    sides = {"R": rk_np, "S": sa_np}
    launches, keys, u32 = {}, {}, {}
    for label, b, p, kw, plan in JOIN_CALLS:
        res, ms = timed_join((sides[b], sides[p]), kw, dev, label, launches)
        row = dict(zip(hdr, ref_rows[plan]))
        want = (int(row["c_htProbe"]), int(row["c_htProbeCmp"]),
                int(row["c_unnest"] if plan.startswith("N") else
                    row["c_top"]))
        got = (res.num_matches, res.num_cmps, res.num_results)
        require(got == want, f"phase 7 {label}: (num_matches, num_cmps, "
                f"num_results) {got}, {REFERENCE_CSV.name} {plan} {want}")
        require(res.route_worst <= 1, f"phase 7 {label}: route_worst "
                f"{res.route_worst}")
        print(join_line(label, res, ms, launches, card))
        keys[label] = join_pairs_key(res, dev)
        u32[label] = res
    maps = key_maps()
    calls = {label: (b, p, kw) for label, b, p, kw, _ in JOIN_CALLS}
    for label, kind, base in merged_calls():
        b, p, kw = calls[base]
        args = (maps[kind](sides[b]), maps[kind](sides[p]))
        res, ms = timed_join(args, kw, dev, label, launches)
        for k in ("num_matches", "num_results"):
            require(getattr(res, k) == getattr(u32[base], k),
                    f"phase 7 {label}: {k} {getattr(res, k)} != the u32 "
                    f"call's {getattr(u32[base], k)}")
        require(torch.equal(join_pairs_key(res, dev), keys[base]),
                f"phase 7 {label}: pairs differ from the u32 call's")
        require(res.route_worst <= 1, f"phase 7 {label}: route_worst "
                f"{res.route_worst}")
        print(join_line(label, res, ms, launches, card))
    phase7_cpu_counters(dev, maps)

    # modes on the Nrs-shaped call, u32 and u64
    for width, kmap in (("u32", lambda k: k), ("u64", maps["u64"])):
        args = (kmap(sa_np), kmap(rk_np))
        inner = join(*args, device=dev)
        hit = np.zeros(rk_np.size, bool)
        hit[inner.probe_rows] = True
        for mode in ("semi", "anti", "left"):
            label = f"Nrs {width} {mode}"
            res, ms = timed_join(args, dict(mode=mode), dev, label, launches)
            want = np.nonzero(hit if mode != "anti" else ~hit)[0]
            if mode == "left":
                miss = np.nonzero(~hit)[0]
                got_key = join_pairs_key(res, dev)
                want_p = np.concatenate([inner.probe_rows, miss])
                want_b = np.concatenate([inner.build_rows,
                                         np.full(miss.size, -1, np.int32)])
                require(torch.equal(got_key, rows_key(want_p, want_b, dev)),
                        f"phase 7 {label}: not inner plus anti with -1")
            else:
                require(np.array_equal(res.probe_rows, want)
                        and (res.build_rows == -1).all(),
                        f"phase 7 {label}: rows differ from the inner "
                        "join's hit set")
            require((res.num_matches, res.num_cmps)
                    == (inner.num_matches, inner.num_cmps),
                    f"phase 7 {label}: counters differ from inner's")
            print(join_line(label, res, ms, launches, card))
    # one post predicate over payload columns
    pp = {"v": (np.arange(rk_np.size) * 7) % 5}
    bp = {"v": (np.arange(sa_np.size) * 3) % 5}

    def pred(p, b):
        return (p["v"] + b["v"]) % 3 != 0

    res, ms = timed_join((sa_np, rk_np), dict(
        predicate=pred, probe_payload=pp, build_payload=bp), dev,
        "Nrs u32 post predicate", launches)
    inner = u32["Nrs"]
    keep = pred({"v": pp["v"][inner.probe_rows]},
                {"v": bp["v"][inner.build_rows]})
    require(torch.equal(join_pairs_key(res, dev),
                        rows_key(inner.probe_rows[keep],
                                 inner.build_rows[keep], dev)),
            "phase 7 post predicate: pairs differ from numpy's filter")
    print(join_line("Nrs u32 post predicate", res, ms, launches, card))
    res, ms = timed_join((maps["u64"](sa_np), maps["u64"](rk_np)),
                         dict(hashfun="fib"), dev, "Nrs u64 fib", launches)
    require(res.num_results == u32["Nrs"].num_results
            and torch.equal(join_pairs_key(res, dev), keys["Nrs"]),
            "phase 7 Nrs u64 fib: pairs differ from the u32 call's")
    print(join_line("Nrs u64 fib", res, ms, launches, card))
    del keys
    methods = phase7_lookup_methods(dev, sides, card)
    faster = {shape: min(ms, key=ms.get) for shape, ms in methods.items()}
    print("phase 7 lookup_auto('auto') takes 'search'; the faster method "
          "here: " + json.dumps(faster))
    for name in JOIN_KERNELS:
        require(sum(c[name] for c in launches.values()) > 0,
                f"{name} not launched in phase 7")
    print(f"phase 7: {time.perf_counter() - t7:.1f} s")
    return launches, methods


#: phase 8a's algebra plans: plan -> (table kind, build side, probe side,
#: IsBuildKeyUnique); "nested_nu" sends the nested tuples to the top
ALGEBRA_PLANS = {"Csr": ("chaining", "R", "S", True),
                 "CsrUU": ("chaining", "R", "S", False),
                 "Crs": ("chaining", "S", "R", False),
                 "Nsr": ("nested", "R", "S", None),
                 "Nrs": ("nested", "S", "R", None),
                 "NrsNU": ("nested_nu", "S", "R", None)}
#: each relation's key column and row-id column
ALGEBRA_COLS = {"R": ("k", "r"), "S": ("a", "s")}
#: phase 8b's fused strands
FUSED_PLANS = ("Csr", "Nsr", "Nrs")
#: phase 8c's plans: exp-1's non-dense route
CLARITY_PLANS = ("Csr", "CsrUU", "Nsr")
CLARITY_MIN_TIME = 0.05
#: phase 8e's goldens (tests/test_algebra.py): the join rows of test2/test3
EXAMPLE_ROWS = [(1, 11, 1, -3), (1, 11, 1, -2), (1, 11, 1, -1),
                (2, 21, 2, -2), (2, 21, 2, -1), (3, 31, 3, -1)]


def host_reads(fn):
    """``(result, cudaStreamSynchronize calls, cudaDeviceSynchronize
    calls)`` of one call of ``fn`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    return (out, names.count("cudaStreamSynchronize"),
            names.count("cudaDeviceSynchronize"))


def wall_ms(fn, reps: int = 3) -> float:
    """Median host milliseconds of ``fn``, the device synchronised around
    each call."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def csv_counters(path, plan_col: int) -> dict:
    """{plan: {column: value}} of a reference CSV."""
    rows = list(csv.reader(io.StringIO(path.read_text()), delimiter=";"))
    return {r[plan_col]: dict(zip(rows[0], r)) for r in rows[1:]}


def top_pairs_key(top, pcol: str, bcol: str) -> torch.Tensor:
    """An AlgTop result's live (pcol, bcol) row-id pairs as one sorted
    int64 column, like ``pairs_multiset_key``."""
    b = top.result
    p = b.columns[pcol][b.mask].to(torch.int64)
    q = b.columns[bcol][b.mask].to(torch.int64)
    return torch.sort(p * (1 << 32) + q).values


def top_nested_key(top, pcol: str) -> torch.Tensor:
    """NrsNU's nested tuples at the AlgTop: (probe row, group key), like
    ``nested_pairs_key``."""
    b = top.result
    nest = b.nests["nest"]
    ukey = nest.table.groups.ukey[nest.group[b.mask].long()]
    packed = (b.columns[pcol][b.mask].to(torch.int64) * (1 << 32)
              + (ukey.to(torch.int64) & 0xFFFFFFFF))
    return torch.sort(packed).values


def algebra_plan(plan: str, rels: dict, nb: int, build_sel=None) -> dict:
    """The operators of one phase 8a plan, the build strand run: the probe
    strand is ``ops["scan_p"].run()``."""
    from hashjoin3d_tpu_torch.models import algebra as alg

    kind, bside, pside, unique = ALGEBRA_PLANS[plan]
    bkey, pkey = ALGEBRA_COLS[bside][0], ALGEBRA_COLS[pside][0]
    top = alg.AlgTop(io.StringIO())
    unn = None
    if kind == "chaining":
        build = alg.AlgHashJoinBuild(bkey, nb)
        probe = alg.AlgHashJoinProbe(top, build, pkey, unique=unique)
        expanding = probe
        cols = ("l." + ALGEBRA_COLS[pside][1], "r." + ALGEBRA_COLS[bside][1])
    else:
        build = alg.AlgNestJoinBuild(bkey, nb)
        if kind == "nested":
            unn = alg.AlgUnnestHt(top)
        probe = alg.AlgNestJoinProbe(unn or top, build, pkey)
        expanding = unn
        cols = (ALGEBRA_COLS[pside][1], "r." + ALGEBRA_COLS[bside][1])
    first = build if build_sel is None else alg.AlgSelection(build,
                                                             build_sel)
    scan_b = alg.AlgScan(first, rels[bside])
    scan_b.run()
    return dict(scan_b=scan_b, build=build, probe=probe, unnest=unn,
                top=top, expanding=expanding, cols=cols,
                scan_p=alg.AlgScan(probe, rels[pside]))


def plan_counters(ops) -> dict:
    out = dict(c_htProbe=ops["probe"].count(),
               c_htProbeCmp=ops["probe"].num_cmps, c_top=ops["top"].count())
    if ops["unnest"] is not None:
        out["c_unnest"] = ops["unnest"].count()
    return out


def plan_key(ops) -> torch.Tensor:
    if ops["expanding"] is None:  # NrsNU
        return top_nested_key(ops["top"], ops["cols"][0])
    return top_pairs_key(ops["top"], *ops["cols"])


def check_fused(plan, ops, want_key, card):
    """8b: ``compile_strand`` of an interpreted plan: counters and pairs
    equal the interpreted run's, a half-size capacity raises; the host
    reads and wall ms of both runs."""
    from hashjoin3d_tpu_torch.models.algebra import compile_strand

    want = plan_counters(ops)
    _, reads_i, dsync_i = host_reads(ops["scan_p"].run)
    ms_i = wall_ms(ops["scan_p"].run)
    run = compile_strand(ops["scan_p"])
    top, reads_f, dsync_f = host_reads(run)
    require(top is ops["top"], f"phase 8b {plan}: compile_strand's top")
    got = plan_counters(ops)
    require(got == want, f"phase 8b {plan}: fused counters {got} != "
            f"interpreted {want}")
    require(torch.equal(plan_key(ops), want_key),
            f"phase 8b {plan}: fused pairs differ from the interpreted run")
    ms_f = wall_ms(run)
    small = compile_strand(ops["scan_p"], out_sizes={
        ops["expanding"]: max(want["c_top"] // 2, 1)})
    raised = False
    try:
        small()
    except ValueError as e:
        raised = "capacity" in str(e)
    require(raised, f"phase 8b {plan}: a half-size capacity did not raise")
    print(f"phase 8b {plan} on {card}: interpreted {ms_i:.3f} ms, "
          f"{reads_i} host reads (cudaStreamSynchronize), {dsync_i} "
          f"device syncs; fused {ms_f:.3f} ms, {reads_f} host reads, "
          f"{dsync_f} device syncs")
    return dict(interpreted_ms=ms_i, interpreted_reads=reads_i,
                fused_ms=ms_f, fused_reads=reads_f)


def sel_expected(rk_np, sa_np, half: int, nb: int):
    """numpy counters of the Csr plan with ``k < half`` under its build:
    a dead row enters no chain, so a chain holds the live rows in
    insertion order, [first, rest LIFO]; a live probe key counts its
    node's 1-based position, a missing one its whole chain."""
    from hashjoin3d_tpu_torch.ops.hashing import hash_key_np

    live = rk_np < half
    b = (hash_key_np(rk_np) % np.uint32(nb)).astype(np.int64)
    rows = np.nonzero(live)[0]
    order = np.argsort(b[rows], kind="stable")
    bs, rs = b[rows][order], rows[order]
    blen = np.bincount(bs, minlength=nb)
    rank = np.arange(bs.size) - np.searchsorted(bs, bs, "left")
    pos = np.where(rank == 0, 0, blen[bs] - rank)
    pos_of_key = np.zeros(rk_np.size, np.int64)
    pos_of_key[rk_np[rs]] = pos
    hit = sa_np < half
    sb = (hash_key_np(sa_np) % np.uint32(nb)).astype(np.int64)
    cmps = np.where(hit, pos_of_key[np.minimum(sa_np, rk_np.size - 1)] + 1,
                    blen[sb])
    return dict(c_htProbe=int(hit.sum()), c_htProbeCmp=int(cmps.sum()),
                c_top=int(hit.sum()))


def phase8a_algebra(dev, card, exp, rk_np, sa_np, ref_csv):
    """8a and 8b: the six plans through the algebra, interpreted, each
    with its launch counts from 0: counters equal the reference CSV's,
    pairs equal the windowed strand's (phase 2's) as multisets; a seventh
    plan with ``k < |R| / 2`` under the Csr build equals numpy; then
    ``compile_strand`` on Csr, Nsr and Nrs.  Returns the launch counts,
    8b's readings and the windowed strands' pairs of 8c's plans."""
    from hashjoin3d_tpu_torch import kernels
    from hashjoin3d_tpu_torch.models.algebra import Relation, print_strand

    card_r, card_s = rk_np.size, sa_np.size
    rels = {"R": Relation(dev, k=rk_np, r=np.arange(card_r, dtype=np.int32)),
            "S": Relation(dev, a=sa_np, s=np.arange(card_s, dtype=np.int32))}
    nbs = {"R": card_r, "S": exp.num_dv_sa}
    ref = csv_counters(ref_csv, 9)
    launches, fused, windowed = {}, {}, {}
    for plan, (_, bside, _, _) in ALGEBRA_PLANS.items():
        jp = exp.join_plan(plan)
        table = jp.build(jp.build_keys)
        out = jp.probe(table, jp.probe_keys)
        want_key = (nested_pairs_key(out, table) if plan == "NrsNU"
                    else pairs_multiset_key(out))
        del jp, table, out
        if plan in CLARITY_PLANS:
            windowed[plan] = want_key
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ops = algebra_plan(plan, rels, nbs[bside])
        ops["scan_p"].run()
        ms = (time.perf_counter() - t0) * 1e3
        launches[plan] = dict(kernels.LAUNCHES)
        got = plan_counters(ops)
        want = {k: int(ref[plan][k]) for k in got}
        require(got == want, f"phase 8a {plan}: counters {got} != "
                f"{ref_csv.name}'s {want}")
        key = plan_key(ops)
        require(torch.equal(key, want_key),
                f"phase 8a {plan}: pairs differ from the windowed strand's")
        buf = io.StringIO()
        print_strand(ops["scan_b"], 1, buf)
        print_strand(ops["scan_p"], 1, buf)
        print(f"phase 8a {plan} on {card}: build + probe {ms:.3f} ms, "
              f"counters {got}, launches " + json.dumps(
                  {k: v for k, v in launches[plan].items() if v}))
        print(buf.getvalue().rstrip())
        if plan in FUSED_PLANS:
            kernels.reset_launch_counts()
            fused[plan] = check_fused(plan, ops, key, card)
            launches[f"{plan} fused"] = dict(kernels.LAUNCHES)
        del ops, key, want_key

    half = card_r // 2
    kernels.reset_launch_counts()
    ops = algebra_plan("Csr", rels, card_r,
                       build_sel=lambda cols: cols["k"] < half)
    ops["scan_p"].run()
    launches["Csr k<|R|/2"] = dict(kernels.LAUNCHES)
    got = plan_counters(ops)
    want = sel_expected(rk_np, sa_np, half, card_r)
    require(got == want, f"phase 8a Csr k<|R|/2: counters {got} != numpy's "
            f"{want}")
    require(ops["build"].count() == half, "phase 8a Csr k<|R|/2: the build "
            "did not count |R| / 2 live rows")
    r_of_key = torch.from_numpy(np.argsort(rk_np).astype(np.int64)).to(dev)
    sa = torch.from_numpy(sa_np.astype(np.int64)).to(dev)
    live = sa < half
    s_rows = torch.arange(card_s, dtype=torch.int64, device=dev)[live]
    want_key = torch.sort(s_rows * (1 << 32) + r_of_key[sa[live]]).values
    require(torch.equal(plan_key(ops), want_key),
            "phase 8a Csr k<|R|/2: pairs differ from numpy's")
    buf = io.StringIO()
    print_strand(ops["scan_p"], 1, buf)
    print(f"phase 8a Csr k<|R|/2 on {card}: counters {got} equal numpy's")
    print(buf.getvalue().rstrip())
    del ops, rels, sa, live, s_rows, want_key
    return launches, fused, windowed


def phase8c_exp1(card, exp, buf, wanted, ref_csv):
    """8c: Csr, CsrUU and Nsr with R.k declared not dense after ``init``
    (``exp`` writes its CSV to ``buf``): rows equal the reference CSV's
    (counters and statistics), pairs equal the windowed strands'
    (``wanted``), route 0."""
    exp.dense_direct_r = False
    launches = run_plans(exp, CLARITY_PLANS)
    hdr, rows = check_rows(buf.getvalue(), ref_csv, CLARITY_PLANS,
                           "phase 8c")
    for plan in CLARITY_PLANS:
        table, out = exp.results[plan]
        require(table.direct is None, f"phase 8c {plan}: a dense table")
        require(out["route_worst"] == 0, f"phase 8c {plan}: route_worst "
                f"{out['route_worst']}")
        require(torch.equal(pairs_multiset_key(out), wanted[plan]),
                f"phase 8c {plan}: pairs differ from the windowed strand's")
        print(plan_line(hdr, rows[plan], "phase 8c non-dense", card))
    return {f"{p} non-dense": c for p, c in launches.items()}


def triples_sorted(out: dict) -> tuple:
    """An exp-4 strand's live triples in (r, s, t) order as two columns:
    r and s << 24 | t (rows below 2^24 at R24)."""
    live = out["r_row"] >= 0
    r, s, t = (out[k][live].to(torch.int64) for k in ("r_row", "s_row",
                                                       "t_row"))
    st = (s << 24) | t
    o1 = torch.sort(st, stable=True).indices
    o2 = torch.sort(r[o1], stable=True).indices
    return r[o1][o2], st[o1][o2]


def phase8d_exp4(dev, card, log2_r, ref_csv):
    """8d: exp-4's clarity strands on ``build_nested`` / ``build_chaining``
    tables at ``log2_r``: counters equal the reference CSV's (Nnu: the
    sorted strand's, c_top numFkCommon), triples (Nnu: hit rows and group
    keys) equal the sorted strands' (phase 6's) as multisets; wall ms of
    both probe strands and both builds."""
    from hashjoin3d_tpu_torch import kernels
    from hashjoin3d_tpu_torch.models import exp4 as m4
    from hashjoin3d_tpu_torch.ops.chaining import build_chaining
    from hashjoin3d_tpu_torch.ops.nested import build_nested

    e = m4.Experiment4(log2_r, **EXP4_PARAMS, plans=EXP4_PLANS, device=dev,
                       trace=False)
    e.init()
    ndv = e.num_fk_common + e.num_fk_exclusive
    card2 = max(e.calc_join_card2(), 1)
    ref = csv_counters(ref_csv, 10)
    csv_of = dict(c_probe_RS="c_probe_RS", c_probe_RS_cmp="c_probe_RS_cmp",
                  c_probe_RT="c_probe_RT", c_probe_RT_cmp="c_probe_RT_cmp",
                  c_unnest_1="c_unnest_S", c_unnest_2="c_unnest_T",
                  c_top="c_top")
    launches = {}
    for plan in EXP4_PLANS:
        ws, wt = e.build(plan, e.sa), e.build(plan, e.ta)
        sorted_out = e.probe(plan, ws, wt, e.rk)
        sorted_ms = wall_ms(lambda: e.probe(plan, ws, wt, e.rk))
        build = build_chaining if plan == "Chj" else build_nested
        kernels.reset_launch_counts()
        ts, tt = build(e.sa, ndv), build(e.ta, ndv)
        if plan == "Ndu":
            def strand():
                return m4._ndu_probe_strand(
                    ts, tt, e.rk, max(card2 // max(e.mult_alpha, 1), 1),
                    card2)
        elif plan == "Chj":
            def strand():
                return m4._chj_probe_strand(
                    ts, tt, e.rk, max(e.calc_join_card1(), 1), card2)
        else:
            def strand():
                return m4._nnu_probe_strand(ts, tt, e.rk)
        out = strand()
        torch.cuda.synchronize()
        launches[f"{plan} R{log2_r} clarity"] = dict(kernels.LAUNCHES)
        for k, col in csv_of.items():
            if k not in out:
                continue
            want = (int(sorted_out[k]) if plan == "Nnu"
                    else int(ref[plan][col]))
            require(int(out[k]) == want, f"phase 8d {plan}: {k} "
                    f"{int(out[k])} != {want}")
        if plan == "Nnu":
            require(int(out["c_top"]) == e.num_fk_common,
                    "phase 8d Nnu: c_top is not numFkCommon")
            for g, tbl in (("g_s", ts), ("g_t", tt)):
                hit = out[g] >= 0
                require(torch.equal(hit, sorted_out[g] >= 0),
                        f"phase 8d Nnu: {g}'s hit rows differ from the "
                        "sorted strand's")
                require(torch.equal(tbl.groups.ukey[out[g][hit].long()],
                                    e.rk[hit]),
                        f"phase 8d Nnu: {g}'s groups do not hold the keys")
        else:
            for a, b in zip(triples_sorted(out),
                            triples_sorted(sorted_out)):
                require(torch.equal(a, b), f"phase 8d {plan}: triples "
                        "differ from the sorted strand's")
        ms = wall_ms(strand)
        build_ms = wall_ms(lambda: build(e.sa, ndv))
        sorted_build_ms = wall_ms(lambda: e.build(plan, e.sa))
        print(f"phase 8d {plan} R{log2_r} on {card}: clarity probe strand "
              f"{ms:.3f} ms vs sorted strand {sorted_ms:.3f} ms; clarity S "
              f"build {build_ms:.3f} ms vs compacted {sorted_build_ms:.3f} "
              "ms; counters " + json.dumps(
                  {k: int(v) for k, v in out.items() if k.startswith("c_")})
              + ", launches " + json.dumps(
                  {k: v for k, v in launches[f"{plan} R{log2_r} clarity"]
                   .items() if v}))
        del ws, wt, ts, tt, out, sorted_out
    del e
    torch.cuda.empty_cache()
    return launches


def phase8e_example(dev, card):
    """8e: algebra_example's four queries on the card, equal to the
    goldens of tests/test_algebra.py."""
    from hashjoin3d_tpu_torch.models import algebra_example as ex

    def rows(top, cols):
        data, mask = top.result.to_numpy(), top.result.mask.cpu().numpy()
        return sorted(tuple(int(data[c][i]) for c in cols)
                      for i in np.nonzero(mask)[0])

    buf = io.StringIO()
    ex.main(["--device", str(dev)], out=buf)
    scan, sel, top = ex.test0(io.StringIO(), dev)
    require((top.count(), sel.count(), scan.count()) == (3, 3, 4),
            "phase 8e test0 counts")
    require(rows(top, ("a", "b")) == [(1, 11), (2, 21), (3, 31)],
            "phase 8e test0 rows")
    o1 = ex.test1(io.StringIO(), dev)
    require([o1[k].count() for k in ("build", "scan_r", "top", "probe",
                                     "sel", "scan_l")] == [6, 6, 3, 3, 3, 4],
            "phase 8e test1 counts")
    o2 = ex.test2(io.StringIO(), dev)
    require([o2[k].count() for k in ("top", "unnest", "probe")] == [6, 6, 3],
            "phase 8e test2 counts")
    require(rows(o2["top"], ("a", "b", "r.c", "r.d")) == EXAMPLE_ROWS,
            "phase 8e test2 rows")
    o3 = ex.test3(io.StringIO(), dev)
    require([o3["top"].count(), o3["probe"].count(), o3["probe"].num_cmps]
            == [6, 6, 10], "phase 8e test3 counts")
    require(rows(o3["top"], ("l.a", "l.b", "r.c", "r.d")) == EXAMPLE_ROWS,
            "phase 8e test3 rows")
    print(f"phase 8e algebra_example on {card}: the four queries equal the "
          "goldens; main's output:")
    print(buf.getvalue().rstrip())


def phase8f_ops(dev, card, sa_np):
    """8f: hash_aggregate (masked, n_keys hint), radix_partition (both
    ways) and compact over the 2^24 rows of S.a on the card, each equal to
    numpy."""
    from hashjoin3d_tpu_torch.ops.aggregate import hash_aggregate
    from hashjoin3d_tpu_torch.ops.filter import apply_predicate, compact
    from hashjoin3d_tpu_torch.ops.hashing import hash_key_np
    from hashjoin3d_tpu_torch.ops.layout import from_numpy_u32
    from hashjoin3d_tpu_torch.ops.sort import radix_partition

    n = sa_np.size
    half = int(sa_np.max()) // 2 + 1
    sa = from_numpy_u32(sa_np, dev)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    live = sa_np < half
    cnt = np.bincount(sa_np[live], minlength=half)
    keys = np.nonzero(cnt)[0]
    sums = np.bincount(sa_np[live], weights=np.nonzero(live)[0].astype(
        np.float64), minlength=half)[keys].astype(np.int64)
    _, first = np.unique(sa_np[live], return_index=True)
    _, last = np.unique(sa_np[live][::-1], return_index=True)
    live_rows = np.nonzero(live)[0]
    t0 = time.perf_counter()
    res = hash_aggregate(sa, {"s": rows}, mask=apply_predicate(
        lambda c: c["a"] < half, {"a": sa}), n_keys=keys.size)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    nk = int(res.n_keys)
    require(nk == keys.size, f"phase 8f hash_aggregate: {nk} keys != "
            f"{keys.size}")
    got = {k: v[:nk].cpu().numpy() for k, v in (
        ("keys", res.keys), ("count", res.count), ("sum", res.sums["s"]),
        ("min", res.mins["s"]), ("max", res.maxs["s"]))}
    require(np.array_equal(got["keys"].view(np.uint32), keys.astype(
        np.uint32)), "phase 8f hash_aggregate: keys differ from numpy's")
    require(np.array_equal(got["count"], cnt[keys]),
            "phase 8f hash_aggregate: counts differ from np.bincount's")
    require(np.array_equal(got["sum"], sums),
            "phase 8f hash_aggregate: sums differ from np.bincount's")
    require(np.array_equal(got["min"], live_rows[first]) and np.array_equal(
        got["max"], live_rows[::-1][last]),
        "phase 8f hash_aggregate: min / max differ from np.unique's")
    del res, got
    parts = 1 << 10
    for by_hash in (True, False):
        t1 = time.perf_counter()
        p, k, r, start, length = radix_partition(sa, parts, rows,
                                                 by_hash=by_hash)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t1) * 1e3
        p_np = ((hash_key_np(sa_np) if by_hash else sa_np)
                % np.uint32(parts)).astype(np.int32)
        want_len = np.bincount(p_np, minlength=parts)
        require(np.array_equal(length.cpu().numpy(), want_len),
                f"phase 8f radix_partition by_hash={by_hash}: part_len "
                "differs from np.bincount's")
        require(np.array_equal(start.cpu().numpy(),
                               np.cumsum(want_len) - want_len),
                f"phase 8f radix_partition by_hash={by_hash}: part_start")
        # numpy's stable argsort by p_np, checked on the card: r is a
        # permutation, p = p_np[r] ascends, r ascends within each part
        rl = r.long()
        same_part = p[1:] == p[:-1]
        require(torch.equal(torch.sort(rl).values, rows.long())
                and torch.equal(p, torch.from_numpy(p_np).to(dev)[rl])
                and bool((p[1:] >= p[:-1]).all())
                and bool((r[1:][same_part] > r[:-1][same_part]).all())
                and torch.equal(k, sa[rl]),
                f"phase 8f radix_partition by_hash={by_hash}: rows differ "
                "from numpy's stable argsort")
        print(f"phase 8f radix_partition by_hash={by_hash} on {card}: "
              f"{pms:.3f} ms, {parts} parts equal numpy")
        del p, k, r, rl, start, length, same_part
    t2 = time.perf_counter()
    mask = apply_predicate(lambda c: c["a"] < half, {"a": sa})
    packed, ids, count = compact(mask, {"a": sa}, 1 << (n - 1).bit_length())
    torch.cuda.synchronize()
    cms = (time.perf_counter() - t2) * 1e3
    c = int(count)
    require(c == live.sum() and np.array_equal(
        ids[:c].cpu().numpy(), live_rows) and np.array_equal(
        packed["a"][:c].cpu().numpy().view(np.uint32), sa_np[live]),
        "phase 8f compact: rows differ from numpy's boolean indexing")
    print(f"phase 8f on {card}: hash_aggregate {ms:.3f} ms ({nk} keys of "
          f"{int(live.sum())} live rows), compact {cms:.3f} ms; all equal "
          "numpy")


def phase8(dev, card, log2_r, log2_s, e1_csv, log2_r4, e4_csv):
    """Phase 8: the clarity layer and the algebra (8a-8f) at exp-1's
    ``log2_r`` / ``log2_s`` against ``e1_csv`` and exp-4's ``log2_r4``
    against ``e4_csv``; returns each plan's launch counts, each counted
    from 0."""
    from hashjoin3d_tpu_torch import kernels
    from hashjoin3d_tpu_torch.models.exp1 import Experiment1

    t8 = time.perf_counter()
    buf = io.StringIO()
    exp = Experiment1(log2_r, log2_s, skew=False, t=0, b=1,
                      plans=CLARITY_PLANS, measure_file=buf,
                      min_runtime_s=CLARITY_MIN_TIME, device=dev)
    exp.init()
    rk_np = exp.rk.cpu().numpy().view(np.uint32)
    sa_np = exp.sa.cpu().numpy().view(np.uint32)
    launches, fused, windowed = phase8a_algebra(dev, card, exp, rk_np, sa_np,
                                                e1_csv)
    launches.update(phase8c_exp1(card, exp, buf, windowed, e1_csv))
    del exp
    torch.cuda.empty_cache()
    launches.update(phase8d_exp4(dev, card, log2_r4, e4_csv))
    kernels.reset_launch_counts()
    phase8e_example(dev, card)
    launches["algebra_example"] = dict(kernels.LAUNCHES)
    kernels.reset_launch_counts()
    phase8f_ops(dev, card, sa_np)
    launches["ops on S.a"] = dict(kernels.LAUNCHES)
    print("phase 8b host reads and wall ms: " + json.dumps(fused))
    print(f"phase 8: {time.perf_counter() - t8:.1f} s")
    return launches


#: phase 9's chunk sizes, each leaving a ragged tail (2^24 S probes: five
#: chunks of 3 x 2^20 and 2^20; 2^20 R probes: 3 x 2^18 and 2^18) whose
#: rows stay multiples of the 2^18-key probe-sort segment, so every chunk
#: takes the segmented sorts (K1, K4)
STREAM_CHUNK_S = 3 << 20
STREAM_CHUNK_R = 3 << 18
STREAM_PLANS = ("Csr", "Nsr", "Crs", "Nrs")
#: phase 9b/9c's streams at the CPU comparison's scale (R18/S22): (label,
#: key map, build side, probe side, table kind, unique, hashfun)
CPU_STREAMS = (("Nrs u64", "u64", "S", "R", "nested", False, "murmur"),
               ("Crs sparse u32", "sparse u32", "S", "R", "chaining", False,
                "murmur"),
               ("Csr u64", "u64", "R", "S", "chaining", True, "murmur"),
               ("Csr dense fib", None, "R", "S", "chaining", True, "fib"))
#: oocbench's column sizes in phase 9d: the peak device memory must not
#: grow from the first to the second
OOC_LOGPS = (25, 27)


def stream_pairs_key(pairs, dev) -> torch.Tensor:
    """A stream's per-chunk pairs as :func:`rows_key`."""
    return rows_key(np.concatenate([p for p, _ in pairs]),
                    np.concatenate([b for _, b in pairs]), dev)


def stream(table, keys, kind, unique, chunk, out_per_chunk):
    """One collecting stream: ``(matches, cmps, unnested or None,
    pairs)``."""
    from hashjoin3d_tpu_torch.ops.streaming import (stream_probe_chaining,
                                                    stream_probe_nested)

    if kind == "nested":
        return stream_probe_nested(table, keys, chunk_size=chunk,
                                   collect_pairs=True,
                                   out_per_chunk=out_per_chunk)
    m, c, pairs = stream_probe_chaining(table, keys, chunk_size=chunk,
                                        unique=unique, collect_pairs=True,
                                        out_per_chunk=out_per_chunk)
    return m, c, None, pairs


def phase9a_exp1(dev, card, launches):
    """Csr, Nsr, Crs and Nrs at R20/S24 t=0: the probe column streamed
    from the host through the table built on the card, with a ragged tail;
    counters equal ``e1_t0c.csv``, pairs the whole-column strand's."""
    from hashjoin3d_tpu_torch import kernels
    from hashjoin3d_tpu_torch.models.exp1 import Experiment1

    ref = csv_counters(REFERENCE_CSV, 9)
    exp = Experiment1(LOG2_R, LOG2_S, skew=False, t=0, device=dev,
                      trace=False)
    exp.init()
    for plan in STREAM_PLANS:
        jp = exp.join_plan(plan)
        table = jp.build(jp.build_keys)
        whole = pairs_multiset_key(jp.probe(table, jp.probe_keys))
        host = exp.sa_np if jp.probe_rel == "S" else exp.rk_np
        chunk = STREAM_CHUNK_S if jp.probe_rel == "S" else STREAM_CHUNK_R
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, c, u, pairs = stream(table, host, jp.impl, plan == "Csr", chunk,
                                1 << LOG2_S)
        ms = (time.perf_counter() - t0) * 1e3
        launches[f"{plan} stream"] = dict(kernels.LAUNCHES)
        want = ref[plan]
        got = dict(c_htProbe=m, c_htProbeCmp=c)
        if u is not None:
            got["c_unnest"] = u
        bad = {k: (v, want[k]) for k, v in got.items() if v != int(want[k])}
        require(not bad, f"phase 9a {plan} stream: counters differ from "
                f"{REFERENCE_CSV.name}: {bad}")
        require(torch.equal(stream_pairs_key(pairs, dev), whole),
                f"phase 9a {plan} stream: pairs differ from the "
                "whole-column strand's")
        print(f"phase 9a {plan} streamed from the host on {card}: "
              f"{host.size} probes in chunks of {chunk}, {ms:.3f} ms with "
              f"the pairs copied back, counters {json.dumps(got)} equal "
              f"{REFERENCE_CSV.name}, pairs the whole-column strand's; "
              f"launches {json.dumps(launched(launches[f'{plan} stream']))}")
        del table, whole, pairs
    del exp
    torch.cuda.empty_cache()


def phase9bc_cpu(dev, card, launches):
    """The merged streams (u64 and sparse u32 keys) and a dense-direct
    ``fib`` stream at R18/S22 on the card against the same streams run
    with the plain versions on the CPU: counters and pairs equal."""
    from hashjoin3d_tpu_torch import kernels
    from hashjoin3d_tpu_torch.ops.chaining import build_chaining_host
    from hashjoin3d_tpu_torch.ops.layout import key_column
    from hashjoin3d_tpu_torch.ops.nested import build_nested_host
    from hashjoin3d_tpu_torch.utils.gen import exp1_data

    rk, sa, _ = exp1_data(CPU_LOG2_R, CPU_LOG2_S, False, 0)
    sides = {"R": rk, "S": sa}
    maps = key_maps()
    for label, kmap, b, p, kind, unique, hf in CPU_STREAMS:
        bk = sides[b] if kmap is None else maps[kmap](sides[b])
        pk = sides[p] if kmap is None else maps[kmap](sides[p])
        nb = int(np.unique(bk).size)
        # S probes: 3 x 2^18-row chunks (the tail 2^18, segment-aligned);
        # R probes: 100,003 (the merged strands sort globally)
        chunk = 3 << 18 if p == "S" else 100_003
        out = []
        for d in (dev, torch.device("cpu")):
            col = key_column(bk, d)
            if kmap is None:
                table = build_chaining_host(col, nb, dense_direct=True,
                                            n_keys=bk.size, hashfun=hf)
            elif kind == "nested":
                table = build_nested_host(col, nb, n_keys=nb, hashfun=hf)
            else:
                table = build_chaining_host(col, nb, n_keys=nb, hashfun=hf)
            require(table.key_direct is None, f"phase 9b {label}: the "
                    "table took the key_direct layout")
            kernels.reset_launch_counts()
            out.append(stream(table, pk, kind, unique, chunk,
                              1 << CPU_LOG2_S))
            if not launches.get(f"{label} stream"):  # the card's run
                torch.cuda.synchronize()
                launches[f"{label} stream"] = dict(kernels.LAUNCHES)
        g, w = out
        require(g[:3] == w[:3], f"phase 9b {label} stream: counters "
                f"{g[:3]} != the CPU run's {w[:3]}")
        require(torch.equal(stream_pairs_key(g[3], dev).cpu(),
                            stream_pairs_key(w[3], "cpu")),
                f"phase 9b {label} stream: pairs differ from the CPU run")
        print(f"phase 9{'c' if kmap is None else 'b'} {label} streamed at "
              f"R{CPU_LOG2_R}/S{CPU_LOG2_S} on {card} (chunks of {chunk}): "
              f"counters {g[:3]} and pairs equal the CPU run; launches "
              f"{json.dumps(launched(launches[f'{label} stream']))}")


def phase9d_oocbench(dev, card, launches):
    """``tools/oocbench.py`` at 2^25 and 2^27 host probes: counters equal
    its numpy model (``run`` raises otherwise); the copy, probe and
    overlap split at 2^27; the peak device memory of each stream equal at
    both sizes within one chunk's working set (the peak above what was
    resident when the stream began)."""
    from hashjoin3d_tpu_torch.tools import oocbench

    runs = {logp: oocbench.run(dev, logp=logp, timings=logp == OOC_LOGPS[-1])
            for logp in OOC_LOGPS}
    last = runs[OOC_LOGPS[-1]]
    for name in ("chaining", "nested"):
        a, b = (runs[lp][name] for lp in OOC_LOGPS)
        working = a["peak_bytes"] - a["resident_bytes"]
        require(abs(b["peak_bytes"] - a["peak_bytes"]) <= working,
                f"phase 9d oocbench {name}: peak device memory "
                f"{a['peak_bytes']} at 2^{OOC_LOGPS[0]} probes, "
                f"{b['peak_bytes']} at 2^{OOC_LOGPS[1]} (one chunk's "
                f"working set {working})")
        for lp in OOC_LOGPS:
            launches[f"oocbench {name} 2^{lp}"] = runs[lp][name]["launches"]
        print(f"phase 9d oocbench {name} on {card}: " + json.dumps(dict(
            {k: b[k] for k in ("counters", "probes_per_s", "ms",
                               "probe_only_ms", "copy_only_ms",
                               "host_copy_ms", "profiled_wall_ms", "busy_ms",
                               "copy_busy_ms", "probe_busy_ms", "overlap_ms",
                               "idle_share", "device_events",
                               "serial_ms", "table_bytes")},
            launches=launched(b["launches"]),
            peak_bytes={f"2^{lp}": runs[lp][name]["peak_bytes"]
                        for lp in OOC_LOGPS},
            resident_bytes={f"2^{lp}": runs[lp][name]["resident_bytes"]
                            for lp in OOC_LOGPS})))
    print(f"phase 9d oocbench H2D from pinned memory on {card}: "
          f"{last['h2d_gbps']:.2f} GB/s")
    return {name: last[name] for name in ("chaining", "nested")}


def phase9(dev, card):
    """Phase 9: out-of-core streaming (9a-9d); returns each stream's
    launch counts, each counted from 0."""
    t9 = time.perf_counter()
    launches = {}
    phase9a_exp1(dev, card, launches)
    phase9bc_cpu(dev, card, launches)
    phase9d_oocbench(dev, card, launches)
    for name in ("bitonic_sort_packed_segmented", "windowed_lookup",
                 "multi_scan"):
        require(sum(c[name] for c in launches.values()) > 0,
                f"{name} not launched in phase 9")
    print(f"phase 9: {time.perf_counter() - t9:.1f} s")
    return launches


#: phase 10's sweeps: exp-1 (R, S = R + 4; plans Csr and Nrs) and exp-4 (R)
#: on both backends, and join's columns (|R| + |S| = 17 * 2^R, R:S 1:16)
CROSS_E1_LOG2_R = (10, 12, 14, 16, 18)
CROSS_E4_LOG2_R = (12, 14, 16, 18)
CROSS_JOIN_LOG2_R = tuple(range(8, 21))
CROSS_MIN_TIME = 0.02


def crossover(points) -> int | None:
    """The smallest row volume from which the device's time stays below
    the host engine's over every larger volume measured; None if the
    host engine wins at the largest."""
    best = None
    for vol, host_ms, dev_ms in sorted(points, reverse=True):
        if dev_ms >= host_ms:
            break
        best = vol
    return best


def phase10a_exp1(dev, card):
    """exp-1 ``all`` on the host engine at R20/S24 t=0 (one rep a plan):
    every row equals ``e1_t0c.csv`` in its value columns (c_*, ht_*)."""
    from hashjoin3d_tpu_torch.models.exp1 import Experiment1

    buf = io.StringIO()
    exp = Experiment1(LOG2_R, LOG2_S, skew=False, t=0, b=1, plans=REF_PLANS,
                      measure_file=buf, min_runtime_s=0.0, min_repeat=1,
                      device=dev, backend="host", trace=False)
    exp.init()
    exp.run()
    hdr, rows = check_rows(buf.getvalue(), REFERENCE_CSV, REF_PLANS,
                           "phase 10a")
    for plan in REF_PLANS:
        print(plan_line(hdr, rows[plan], f"phase 10a host engine "
                        f"R{LOG2_R}/S{LOG2_S} t=0", card))


def phase10b_exp4(card):
    """exp-4's Ndu and Chj on the host engine at R20: rows equal
    ``e4_20.csv`` in every value column."""
    from hashjoin3d_tpu_torch.models.exp4 import Experiment4

    _, log2_r, ref, _ = EXP4_RUNS[1]
    buf = io.StringIO()
    exp = Experiment4(log2_r, **EXP4_PARAMS, plans=("Ndu", "Chj"),
                      measure_file=buf, min_runtime_s=0.0, min_repeat=1,
                      device="cpu", backend="host", trace=False)
    exp.init()
    exp.run()
    rows = list(csv.reader(io.StringIO(buf.getvalue()), delimiter=";"))
    hdr, got = rows[0], {r[10]: r for r in rows[1:]}
    ref_rows = list(csv.reader(io.StringIO(ref.read_text()), delimiter=";"))
    require(ref_rows[0] == hdr, "phase 10b: CSV header differs")
    keep = [i for i, c in enumerate(hdr) if c.startswith(("c_", "card"))
            or c in ("plan", "ht_impl", "log2CardR", "a", "aM", "b", "bM")]
    for want in ref_rows[1:]:
        bad = [(hdr[i], got[want[10]][i], want[i]) for i in keep
               if got[want[10]][i] != want[i]]
        require(not bad, f"phase 10b {want[10]}: row differs from "
                f"{ref.name}: {bad}")
        print(exp4_line(hdr, got[want[10]], f"phase 10b host engine "
                        f"R{log2_r}", card))


def phase10c_join(dev, card) -> dict:
    """``join`` (nested, build R probe S) on both backends, |R| + |S| from
    4,352 to 17.8M in steps of 2x: equal counters, the median wall ms of 3
    each, and the crossover."""
    from hashjoin3d_tpu_torch import join
    from hashjoin3d_tpu_torch.utils.gen import exp1_data

    points = []
    for lr in CROSS_JOIN_LOG2_R:
        rk, sa, _ = exp1_data(lr, lr + 4, False, 0)
        res, ms = {}, {}
        for backend in ("host", "device"):
            def call():
                return join(rk, sa, backend=backend, device=dev)
            res[backend] = call()  # warm-up, and the result checked
            ms[backend] = wall_ms(call)
        h, d = res["host"], res["device"]
        require((h.num_matches, h.num_cmps, h.num_results)
                == (d.num_matches, d.num_cmps, d.num_results),
                f"phase 10c join at R{lr}: host and device counters differ")
        vol = rk.size + sa.size
        points.append((vol, ms["host"], ms["device"]))
        print(f"phase 10c join |R|+|S| = {vol} on {card}: host "
              f"{ms['host']:.3f} ms, device {ms['device']:.3f} ms (median "
              f"of 3), num_results {h.num_results}")
    return dict(points=points, crossover=crossover(points))


def phase10d_sweeps(dev, card) -> dict:
    """exp-1 (Csr, Nrs) and exp-4 (Ndu, Chj) on both backends over the
    sweep sizes: t_total a plan (build + probe, the reference's protocol
    at CROSS_MIN_TIME) and the crossover in each harness's row volume."""
    from hashjoin3d_tpu_torch.models.exp1 import Experiment1
    from hashjoin3d_tpu_torch.models.exp4 import Experiment4

    out = {}
    points = []
    for lr in CROSS_E1_LOG2_R:
        t = {}
        for backend in ("host", "device"):
            buf = io.StringIO()
            exp = Experiment1(lr, lr + 4, False, 0, plans=("Csr", "Nrs"),
                              measure_file=buf, min_runtime_s=CROSS_MIN_TIME,
                              min_repeat=3, device=dev, backend=backend,
                              trace=False)
            exp.init()
            exp.run()
            hdr, rows = plan_rows(buf.getvalue())
            i = hdr.index("t_total")
            t[backend] = {p: int(r[i]) / 1e6 for p, r in rows.items()}
        vol = (1 << lr) + 2 * (1 << (lr + 4))
        points.append((vol, max(t["host"].values()),
                       max(t["device"].values())))
        print(f"phase 10d exp-1 R{lr}/S{lr + 4} (plan volume {vol}) on "
              f"{card}: t_total ms host {json.dumps(t['host'])}, device "
              f"{json.dumps(t['device'])}")
    out["exp1"] = dict(points=points, crossover=crossover(points))
    points = []
    for lr in CROSS_E4_LOG2_R:
        t = {}
        for backend in ("host", "device"):
            buf = io.StringIO()
            exp = Experiment4(lr, **EXP4_PARAMS, plans=("Ndu", "Chj"),
                              measure_file=buf, min_runtime_s=CROSS_MIN_TIME,
                              min_repeat=3, device=dev, backend=backend,
                              trace=False)
            exp.init()
            exp.run()
            rows = list(csv.reader(io.StringIO(buf.getvalue()),
                                   delimiter=";"))
            i = rows[0].index("t_total")
            t[backend] = {r[10]: int(r[i]) / 1e6 for r in rows[1:]}
        vol = (exp.card_r + exp.card_s + exp.card_t + exp.calc_join_card2())
        points.append((vol, max(t["host"].values()),
                       max(t["device"].values())))
        print(f"phase 10d exp-4 R{lr} (row volume {vol}) on {card}: "
              f"t_total ms host {json.dumps(t['host'])}, device "
              f"{json.dumps(t['device'])}")
    out["exp4"] = dict(points=points, crossover=crossover(points))
    return out


def phase10(dev, card) -> dict:
    """Phase 10: the host engine (10a-10d); returns the crossovers."""
    t10 = time.perf_counter()
    phase10a_exp1(dev, card)
    print(f"phase 10a: {time.perf_counter() - t10:.1f} s")
    phase10b_exp4(card)
    from hashjoin3d_tpu_torch import api
    from hashjoin3d_tpu_torch.models.exp1 import Experiment1
    from hashjoin3d_tpu_torch.models.exp4 import Experiment4

    cross = dict(join=phase10c_join(dev, card), **phase10d_sweeps(dev, card))
    print(f"phase 10 crossovers on {card} (the smallest row volume from "
          "which the device beats the host engine at every larger size "
          "measured): " + json.dumps({k: v["crossover"]
                                      for k, v in cross.items()})
          + "; the port's HOST_CROSSOVER_ROWS: " + json.dumps(dict(
              join=api.HOST_CROSSOVER_ROWS,
              exp1=Experiment1.HOST_CROSSOVER_ROWS,
              exp4=Experiment4.HOST_CROSSOVER_ROWS)))
    print(f"phase 10: {time.perf_counter() - t10:.1f} s")
    return cross


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

    # phase 7: join, the one-call API, on the card
    join_launches, lookup_ms = phase7_join(dev, card, rk_np, sa_np)
    print("phase 7 lookup methods (ms): " + json.dumps(lookup_ms))
    print(f"smoke so far {time.perf_counter() - t0:.1f} s")

    # phase 8: the clarity layer and the algebra on the card
    _, log2_r4, e4_csv, _ = EXP4_RUNS[0]
    algebra_launches = phase8(dev, card, LOG2_R, LOG2_S, REFERENCE_CSV,
                              log2_r4, e4_csv)
    joins = [*ALGEBRA_PLANS, "Csr k<|R|/2",
             *(f"{p} non-dense" for p in CLARITY_PLANS),
             *(f"{p} R{log2_r4} clarity" for p in EXP4_PLANS)]
    for plan in joins:
        for name in ("windowed_lookup", "multi_scan"):
            require(algebra_launches[plan][name] > 0,
                    f"{name} not launched in phase 8's {plan}")
    for plan, counts in algebra_launches.items():
        print(f"launches phase 8 {plan}: " + json.dumps(
            {k: v for k, v in counts.items() if v}))
    print(f"smoke so far {time.perf_counter() - t0:.1f} s")

    # phase 9: out-of-core streaming on the card
    stream_launches = phase9(dev, card)
    for label, counts in stream_launches.items():
        print(f"launches phase 9 {label}: " + json.dumps(
            {k: v for k, v in counts.items() if v}))
    print(f"smoke so far {time.perf_counter() - t0:.1f} s")

    # phase 10: the host engine, and the crossovers of backend="auto"
    phase10(dev, card)
    print(f"smoke so far {time.perf_counter() - t0:.1f} s")

    entries = [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=after2[key],
             plan_launches={p: c[key] for p, c in plan_launches.items()},
             miss_probe_launches=after3[key],
             tool_launches=tools[key],
             probe_tool_launches=probe_tools[key],
             join_launches={c: n[key] for c, n in join_launches.items()},
             algebra_launches={p: c[key] for p, c in algebra_launches.items()
                               if c[key]},
             stream_launches={p: c[key] for p, c in stream_launches.items()},
             **results[name])
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
            probe_tool_launches=probe_tools[key],
            join_launches={c: n[key] for c, n in join_launches.items()},
            algebra_launches={p: c[key] for p, c in algebra_launches.items()
                              if c[key]},
            stream_launches={p: c[key] for p, c in stream_launches.items()},
            **probe_results[pid]))
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
