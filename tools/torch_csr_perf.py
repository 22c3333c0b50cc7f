#!/usr/bin/env python3
"""Device-time measurements of the PyTorch/CUDA port's Csr path at R20/S24.

Needs one CUDA GPU; imports ``torch`` and the port, never JAX.  Every run
prints the card and its power limit (``nvidia-smi``) first.

``times``: per-kernel and per-strand times of one tree, one JSON line::

    python3 tools/torch_csr_perf.py times --side NAME [--root TREE]

  K1 (the packed probe sort of S.a), K4 2-op take_min (2^24 keys over
  [0, 2^20 + 2^18), numpy seed 0) and K4 1-op signed (S.a's bucket ids with
  30% -1 markers, numpy seed 1): each the mean of 20 launches on CUDA
  events after one warm-up launch.  The Csr probe strand: the median host
  time of 20 runs, each between two ``torch.cuda.synchronize()`` calls.
  ``--root`` imports the port from another tree (a ``git archive`` of a
  commit), so one machine compares two trees: run parent, change, change,
  parent, each in its own process.

``profile``: where the time of the build and the probe strand goes::

    python3 tools/torch_csr_perf.py profile [--reps 10]

  Each strand runs ``reps`` times in one ``torch.profiler`` window, between
  two synchronisations.  Printed per rep: the window's host wall time, the
  device busy time (union of the device's kernel, copy and set intervals in
  that window) and the idle share ``1 - busy / wall`` of that same window;
  the device time and count by kernel name; the top host ops by self time.
  The median unprofiled wall time of the same strand, in the same process,
  stands beside it (the profiler itself slows the host).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

LOG2_R, LOG2_S = 20, 24
SEGMENT, KEY_BITS = 1 << 18, 20


def card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def events_ms(fn, reps: int = 20) -> float:
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


def host_ms(fn, reps: int = 20) -> list[float]:
    """Host milliseconds of each of ``reps`` synchronised calls, after one
    warm-up call."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def strands(dev):
    """(build, probe) closures of plan Csr on the reference's R20/S24 data,
    and S.a."""
    from hashjoin3d_tpu_torch.ops.chaining import build_chaining_host
    from hashjoin3d_tpu_torch.ops.layout import from_numpy_u32
    from hashjoin3d_tpu_torch.ops.strands_windowed import (
        direct_probe_strand_sorted)
    from hashjoin3d_tpu_torch.utils.gen import exp1_data

    rk_np, sa_np, _ = exp1_data(LOG2_R, LOG2_S, False, 0)
    rk, sa = from_numpy_u32(rk_np, dev), from_numpy_u32(sa_np, dev)

    def build():
        return build_chaining_host(rk, 1 << LOG2_R, dense_direct=True,
                                   n_keys=1 << LOG2_R)

    table = build()
    return build, lambda: direct_probe_strand_sorted(table, sa,
                                                     unique=True), sa


def times(side: str, dev) -> dict:
    from hashjoin3d_tpu_torch.ops import bitonic
    from hashjoin3d_tpu_torch.ops.hashing import bucket_of, hash_key
    from hashjoin3d_tpu_torch.ops.layout import I32, from_numpy_u32

    _, probe, sa = strands(dev)
    n = 1 << LOG2_S
    lid = torch.arange(n, dtype=I32, device=dev) % SEGMENT
    wide = from_numpy_u32(np.random.default_rng(0).integers(
        0, (1 << LOG2_R) + (1 << 18), n, dtype=np.uint32), dev)
    dead = torch.from_numpy(np.random.default_rng(1).random(n) < 0.3).to(dev)
    ids = torch.where(dead, -1, bucket_of(hash_key(sa), 1 << LOG2_R))
    return dict(
        side=side,
        k1_ms=events_ms(lambda: bitonic.bitonic_sort_packed_segmented(
            sa, SEGMENT, KEY_BITS)),
        k4_2op_ms=events_ms(lambda: bitonic.bitonic_sort_segmented(
            wide, SEGMENT, payload=lid, stable=False)),
        k4_1op_ms=events_ms(lambda: bitonic.bitonic_sort_segmented(
            ids, SEGMENT, unsigned=False)),
        probe_ms_median=statistics.median(host_ms(probe)))


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


def profile_strand(name: str, fn, reps: int) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    unprofiled = statistics.median(host_ms(fn, reps))
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    events = list(prof.events())
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = busy_us((e.time_range.start, e.time_range.end)
                   for e in device) / 1e3 / reps
    by_name = defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3 / reps
        by_name[e.name][1] += 1
    print(json.dumps(dict(
        strand=name, reps=reps, wall_ms_profiled=wall, busy_ms=busy,
        idle_share=1 - busy / wall, wall_ms_unprofiled_median=unprofiled,
        device_events_per_rep=len(device) / reps)))
    print(f"  -- device time per rep by kernel ({name}):")
    for kname, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"    {ms:8.4f} ms  x{cnt / reps:g}  {kname[:100]}")
    print(f"  -- host self time per rep, top 12 ({name}):")
    host = [a for a in prof.key_averages()
            if a.device_type == DeviceType.CPU and a.self_cpu_time_total > 0]
    host.sort(key=lambda a: -a.self_cpu_time_total)
    for a in host[:12]:
        print(f"    {a.self_cpu_time_total / 1e3 / reps:8.4f} ms  "
              f"x{a.count / reps:g}  {a.key[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    t = sub.add_parser("times")
    t.add_argument("--side", required=True)
    t.add_argument("--root", type=Path,
                   default=Path(__file__).resolve().parents[1])
    p = sub.add_parser("profile")
    p.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_csr_perf: needs a CUDA GPU", file=sys.stderr)
        return 2
    root = (args.root if args.mode == "times"
            else Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root))
    import hashjoin3d_tpu_torch
    if Path(hashjoin3d_tpu_torch.__file__).resolve().parents[1] != root:
        print(f"torch_csr_perf: imported {hashjoin3d_tpu_torch.__file__}, "
              f"not the tree {root}", file=sys.stderr)
        return 2
    print(card())
    dev = torch.device("cuda", 0)
    if args.mode == "times":
        print(json.dumps(times(args.side, dev)))
    else:
        build, probe, _ = strands(dev)
        profile_strand("build", build, args.reps)
        profile_strand("probe", probe, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
