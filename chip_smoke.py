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
   the main-path shapes: K2 and K3 bit-equal; K1 and K4 with keys equal and
   each segment's row ids a permutation that carries its own key; then K1
   and K4 at other segment sizes (256 .. 2^15) and key widths;
2. ``Experiment1(20, 24, Csr, device="cuda")``: its CSV c_* and ht_* columns
   equal the reference's Csr row (``artifacts/r5/e1_t0c.csv``),
   ``route_worst`` is 0, the result pairs equal (as a multiset) those of the
   same build and strand run with the plain versions on CPU copies;
3. a Csr probe with misses (2^24 keys, numpy seed 0, over
   [0, 2^20 + 2^18)): counters bit-equal and pairs multiset-equal to the
   CPU plain run;
4. launch counts, reset just before phase 2: K1, K2, K3 launched in phase 2,
   K4 in phase 3 (R20/S24 never misses, so its main path bypasses K4).

Prints one JSON line of per-kernel results, then, last,
``{"ok": true, "device": {...}}``.  ``launches`` there is the main path's
count (phase 2 alone); ``miss_probe_launches`` is phase 3's.  Nothing here
imports JAX.
"""

from __future__ import annotations

import csv
import io
import json
import subprocess
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
        "hashjoin3d_tpu_torch/csrc/bitonic.cu",
        "hashjoin3d_tpu/ops/bitonic.py:290", "bitonic_sort_packed_segmented"),
    "K2 windowed_lookup": (
        "hashjoin3d_tpu_torch/csrc/windowed.cu",
        "hashjoin3d_tpu/ops/windowed.py:168", "windowed_lookup"),
    "K3 multi_scan": (
        "hashjoin3d_tpu_torch/csrc/scan.cu",
        "hashjoin3d_tpu/ops/scan.py:224", "multi_scan"),
    "K4 bitonic_sort_segmented": (
        "hashjoin3d_tpu_torch/csrc/bitonic.cu",
        "hashjoin3d_tpu/ops/bitonic.py:247", "bitonic_sort_segmented"),
}


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


def check_sort_shapes(dev):
    """K1 and K4 at other segment sizes and key widths than the main path's
    (2^16 keys): keys equal to the plain sort; stable 2-op bit-equal;
    take_min rows a per-segment permutation carrying their keys."""
    from hashjoin3d_tpu_torch.ops import bitonic
    from hashjoin3d_tpu_torch.ops.layout import I32

    gen = torch.Generator(device=dev).manual_seed(1)
    n = 1 << 16
    for chunk in (256, 2048, 1 << 13, 1 << 15):
        lid = torch.arange(n, dtype=I32, device=dev) % chunk
        keys = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                             device=dev, dtype=I32) >> 20  # heavy ties
        (g1,) = bitonic.bitonic_sort_segmented(keys, chunk, unsigned=False)
        (w1,) = bitonic.plain_sort_segmented(keys, chunk, unsigned=False)
        require(torch.equal(g1, w1), f"K4 1-op signed, chunk {chunk}")
        got = bitonic.bitonic_sort_segmented(keys, chunk, payload=lid)
        want = bitonic.plain_sort_segmented(keys, chunk, lid)
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"K4 2-op stable u32, chunk {chunk}")
        gk, gr = bitonic.bitonic_sort_segmented(keys, chunk, payload=lid,
                                                unsigned=False, stable=False)
        require(torch.equal(gk, bitonic.plain_sort_segmented(
            keys, chunk, lid, unsigned=False)[0]),
            f"K4 2-op take_min i32, chunk {chunk}")
        check_segment_rows(keys, gk, gr, chunk, f"K4 take_min {chunk}")
        for key_bits in (8, 20, 31):
            small = keys & ((1 << key_bits) - 1)
            sk, rows = bitonic.bitonic_sort_packed_segmented(small, chunk,
                                                             key_bits)
            require(torch.equal(sk, bitonic.plain_sort_segmented(
                small, chunk, lid)[0]), f"K1 chunk {chunk} bits {key_bits}")
            check_segment_rows(small, sk, rows, chunk,
                               f"K1 chunk {chunk} bits {key_bits}")


def phase1_kernels(rk, sa, ops):
    """Each kernel vs its plain version at the main-path shapes."""
    from hashjoin3d_tpu_torch.ops import bitonic, scan, windowed
    from hashjoin3d_tpu_torch.ops.hashing import bucket_of, hash_key
    from hashjoin3d_tpu_torch.ops.layout import I32

    results = {}
    dev = sa.device
    # K1: the probe sort of S.a (2^24 keys < 2^20, 2^18 segments)
    sk, rows = bitonic.bitonic_sort_packed_segmented(sa, SEGMENT, KEY_BITS)
    lid = torch.arange(sa.shape[0], dtype=I32, device=dev) % SEGMENT
    psk, _ = bitonic.plain_sort_segmented(sa, SEGMENT, lid)
    require(torch.equal(sk, psk), "K1: keys differ from the plain sort")
    check_segment_rows(sa, sk, rows, SEGMENT, "K1")
    results["K1 bitonic_sort_packed_segmented"] = dict(
        max_abs_err=max_abs_err(sk, psk),
        ms=cuda_ms(lambda: bitonic.bitonic_sort_packed_segmented(
            sa, SEGMENT, KEY_BITS)),
        plain_ms=cuda_ms(lambda: bitonic.plain_sort_segmented(
            sa, SEGMENT, lid)))

    # K2: the packed direct words of the sorted probes (T = 2^20, W = 8192)
    direct = ops["table"].direct
    got = windowed.windowed_lookup(direct, sk, W=WINDOW)
    want = windowed.windowed_lookup_plain(direct, sk, W=WINDOW)
    require(torch.equal(got, want), "K2: differs from the plain lookup")
    results["K2 windowed_lookup"] = dict(
        max_abs_err=max_abs_err(got, want),
        ms=cuda_ms(lambda: windowed.windowed_lookup(direct, sk, W=WINDOW)),
        plain_ms=cuda_ms(lambda: windowed.windowed_lookup_plain(
            direct, sk, W=WINDOW)))

    # K3: run_boundaries' scans over the build's sorted bucket column
    b = bucket_of(hash_key(rk), 1 << LOG2_R)
    b_sorted = torch.sort(b, stable=True).values
    i = torch.arange(b.shape[0], dtype=I32, device=dev)
    is_first = torch.ones_like(b, dtype=torch.bool)
    is_first[1:] = b_sorted[1:] != b_sorted[:-1]
    fwd = (is_first.to(I32), torch.where(is_first, i, -1))
    nxt = torch.full_like(i, b.shape[0])
    nxt[:-1] = torch.where(is_first, i, b.shape[0])[1:]
    gen = torch.Generator(device=dev).manual_seed(0)
    pair = tuple(torch.randint(-50, 50, b.shape, generator=gen, device=dev,
                               dtype=I32) for _ in range(2))
    err = 0
    for cols, op, rev in ((fwd, ("sum", "max"), False),
                          ((nxt,), ("min",), True),
                          (pair, ("maxpair",), True)):
        got = scan.multi_scan(cols, op, reverse=rev)
        want = scan.multi_scan_plain(cols, op, reverse=rev)
        for g, w in zip(got, want):
            require(torch.equal(g, w), f"K3 {op} reverse={rev}: differs")
            err = max(err, max_abs_err(g, w))
    results["K3 multi_scan"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: scan.multi_scan(fwd, ("sum", "max"))),
        plain_ms=cuda_ms(lambda: scan.multi_scan_plain(fwd, ("sum", "max"))))

    # K4 (a) 1-op signed: miss-walk bucket ids with -1 dead markers
    bucket_ids = bucket_of(hash_key(sa), 1 << LOG2_R)
    dead = torch.rand(sa.shape, generator=gen, device=dev) < 0.3
    bucket_ids = torch.where(dead, -1, bucket_ids)
    (got1,) = bitonic.bitonic_sort_segmented(bucket_ids, SEGMENT,
                                             unsigned=False)
    (want1,) = bitonic.plain_sort_segmented(bucket_ids, SEGMENT,
                                            unsigned=False)
    require(torch.equal(got1, want1), "K4 1-op: differs from the plain sort")
    # K4 (b) 2-op u32, take_min ties: probe keys past the packed domain
    wide = ops["wide_keys"]
    gk, gr = bitonic.bitonic_sort_segmented(wide, SEGMENT, payload=lid,
                                            stable=False)
    wk, _ = bitonic.plain_sort_segmented(wide, SEGMENT, lid)
    require(torch.equal(gk, wk), "K4 2-op: keys differ from the plain sort")
    check_segment_rows(wide, gk, gr, SEGMENT, "K4 2-op")
    results["K4 bitonic_sort_segmented"] = dict(
        max_abs_err=max(max_abs_err(got1, want1), max_abs_err(gk, wk)),
        ms=cuda_ms(lambda: bitonic.bitonic_sort_segmented(
            wide, SEGMENT, payload=lid, stable=False)),
        plain_ms=cuda_ms(lambda: bitonic.plain_sort_segmented(
            wide, SEGMENT, lid)))
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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
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

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=after2[key],
             miss_probe_launches=after3[key] - after2[key], **results[name])
        for name, (src, rep, key) in KERNELS.items()]}))
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
