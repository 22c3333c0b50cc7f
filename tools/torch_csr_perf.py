#!/usr/bin/env python3
"""Device-time measurements of the PyTorch/CUDA port's Csr path at R20/S24
(and, in ``profile``, of every exp-1 plan there and of exp-4's plans).

Needs one CUDA GPU; imports ``torch`` and the port, never JAX.  Every run
prints the card and its power limit (``nvidia-smi``) first.

``times``: per-kernel and per-strand times of one tree, one JSON line::

    python3 tools/torch_csr_perf.py times --side NAME [--root TREE]

  K1 (the packed probe sort of S.a), K4 2-op take_min (2^24 keys over
  [0, 2^20 + 2^18), numpy seed 0), K4 1-op signed (S.a's bucket ids with
  30% -1 markers, numpy seed 1), K4 stable with a payload over
  [-2^15, 2^15) (numpy seed 2), K1 at 8192-key segments, K2 and K2b
  (W = 8192) and ``index_select`` on the K1-sorted S.a over the build's
  direct words (T = 2^20), P8 (8 rows from row 3 of 2048) and ``clone`` of
  the same rows, K2 with its coverage and ``safe_lookup`` on the sorted
  S.a (W = 8192), P7 at B = 1024, 8192 and 65536 over 2^24 words and
  ``clone`` of those words: each the mean of 20 calls on CUDA events after
  one warm-up call; whether K2b equals the plain lookup on that stream and
  on it with the keys divisible by 5 made -1 holes, whether K2's words,
  coverage flags and count equal the plain version's on it and on it
  rolled by a third of a chunk, and whether P7's copies equal their
  source.  K3's two build calls at 2^20 (``k3_calls``: forward sum + max,
  reverse min) and P5 at C = 1024 and 4096 on 2^22 words with
  ``index_select`` of the same (``p5_cases``), each the mean of 200 calls,
  and whether both kernels equal their plain versions there.  The Csr
  build and probe strands: the median host time of 20 runs, each between
  two ``torch.cuda.synchronize()`` calls; and ``Experiment1``'s
  ``t_buildStr`` and ``t_probeStr`` (ns, the reference's repetition
  protocol).
  ``--root`` imports the port from another tree (a ``git archive`` of a
  commit), so one machine compares two trees: run parent, change, change,
  parent, each in its own process.

``profile``: where the time of the build and the probe strand goes::

    python3 tools/torch_csr_perf.py profile [--reps 10] [--root TREE]
        [--plans Csr,CsrUU,Crs,Nsr,Nrs,NrsNU,CsrSel,CrsSel,NrsSel,Ndu,Chj,Nnu]

  ``--plans`` (default Csr) names the plans to profile: an exp-1 plan at
  R20/S24 t=0, its build and probe strand; a plan other than Csr takes its
  strands from ``Experiment1.join_plan`` (a tree without it profiles Csr
  only).  An exp-4 plan (Ndu, Chj, Nnu) runs at ``-R 24 -a 4 -A 4 -b 2
  -B 2``, its S build, T build and probe strand, as ``Experiment4``
  wires them (``build``, ``probe``).

  Each strand runs ``reps`` times in one ``torch.profiler`` window, between
  two synchronisations.  Printed per rep: the window's host wall time, the
  device busy time (union of the device's kernel, copy and set intervals in
  that window) and the idle share ``1 - busy / wall`` of that same window;
  the device time and count by kernel name; the top host ops by self time.
  The median unprofiled wall time of the same strand, in the same process,
  stands beside it (the profiler itself slows the host).

``launch``: the host cost of a kernel wrapper's launch path and the device
time of the kernels, one JSON line::

    python3 tools/torch_csr_perf.py launch [--root TREE] [--probes [IDS]]

  Host microseconds per call (``time.perf_counter`` over 10^4 calls, no
  synchronisation) of each step a wrapper may take: two ways to get the
  current stream's handle, a ``ctypes.c_void_p`` against a plain
  ``data_ptr()``, the device rule, two ways to allocate the output, a
  row slice, a ctypes call with no arguments, the bound P8 entry point
  called with fixed arguments that it rejects (no rows: ctypes, argument
  conversion and the checks, no launch) and that it launches; then P8
  (``probes.row_copy``) and ``clone`` of the same 8 rows,
  each split into host and device time per call
  (``utils.measure.host_device_us``), and their time per call on CUDA
  events over 20 and over 2000 calls issued back to back; then K3's two
  build calls the same way, with their device operations a call and
  names (``device_ops``) and events over 10 calls as well; P5's two
  runner cases and ``index_select`` of the same, host and device; K1, K2
  with coverage, K2b, K4 2-op and P7 at the inputs of ``times``, host and
  device (200 and 20 calls).  Last, the probe section (alone with
  ``--probes``; ``--probes P3,P4`` keeps those ids): the probe runner's
  own cases of P1, P2, P3 (axis 1 and axis 0), P4, P6 and P9
  (``mosaic_probe.cases``) and the library call of each where it has one
  (``torch.roll``, ``torch.gather``, ``torch.cumsum``, ``torch.matmul``
  f32): host and device µs a call, device operations a call and their
  names; for each kernel its bound, its device share of the bound and its
  device time over its library call's.  One line a case and side follows
  the JSON line.
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
SEGMENT, KEY_BITS, WINDOW = 1 << 18, 20, 8192
P7_BLOCKS = (1024, 8192, 65536)  # the TPU probe's block sizes
#: the probe runner's probes timed in the launch mode's probe section
LAUNCH_PROBES = ("P1", "P2", "P3", "P4", "P6", "P9")


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
    S.a and R.k."""
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
                                                     unique=True), sa, rk


def plan_strands(dev, plan: str):
    """(build, probe) closures of an exp-1 plan at R20/S24 t=0, wired as
    ``Experiment1`` wires it."""
    from hashjoin3d_tpu_torch.models.exp1 import Experiment1

    exp = Experiment1(LOG2_R, LOG2_S, False, 0, plans=(plan,), trace=False,
                      device=dev)
    exp.init()
    jp = exp.join_plan(plan)
    table = jp.build(jp.build_keys)
    return (lambda: jp.build(jp.build_keys),
            lambda: jp.probe(table, jp.probe_keys))


EXP4_PLANS = ("Ndu", "Chj", "Nnu")


def exp4_strands(dev, plan: str) -> dict:
    """{strand name: closure} of an exp-4 plan at R24 -a 4 -A 4 -b 2 -B 2:
    the S build, the T build and the probe of R.k."""
    from hashjoin3d_tpu_torch.models.exp4 import Experiment4

    exp = Experiment4(24, 4, 4, 2, 2, plans=(plan,), trace=False,
                      device=dev)
    exp.init()
    tbl_s, tbl_t = exp.build(plan, exp.sa), exp.build(plan, exp.ta)
    return {"build S": lambda: exp.build(plan, exp.sa),
            "build T": lambda: exp.build(plan, exp.ta),
            "probe R": lambda: exp.probe(plan, tbl_s, tbl_t, exp.rk)}


def k3_calls(rk) -> dict:
    """The build's two K3 calls as ``run_boundaries`` makes them, over the
    stably sorted bucket column of R.k (2^20): forward (sum, max) of
    ``is_first`` and ``where(is_first, i, -1)``, reverse min of the next
    run's start; name -> (columns, ops, reverse)."""
    from hashjoin3d_tpu_torch.ops.hashing import bucket_of, hash_key
    from hashjoin3d_tpu_torch.ops.layout import I32

    b = torch.sort(bucket_of(hash_key(rk), 1 << LOG2_R), stable=True).values
    n = b.shape[0]
    i = torch.arange(n, dtype=I32, device=b.device)
    is_first = torch.ones_like(b, dtype=torch.bool)
    is_first[1:] = b[1:] != b[:-1]
    nxt = torch.full_like(i, n)
    nxt[:-1] = torch.where(is_first, i, n)[1:]
    return {"k3_fwd": ((is_first.to(I32), torch.where(is_first, i, -1)),
                       ("sum", "max"), False),
            "k3_rev": ((nxt,), ("min",), True)}


def p5_cases(dev) -> dict:
    """The probe runner's P5 cases: 2^22 random words (numpy seed 4) and a
    permutation of C = 1024 and 4096 (seeds 5, 6); C -> (x, perm)."""
    x = torch.from_numpy(np.random.default_rng(4).integers(
        0, 1 << 30, (1 << 15, 128), dtype=np.int32)).to(dev)
    return {C: (x, torch.from_numpy(np.random.default_rng(seed).permutation(
        C).astype(np.int32)).to(dev)) for C, seed in ((1024, 5), (4096, 6))}


def probe_launch_cases(dev, probe_ids=LAUNCH_PROBES,
                       shrink: int = 0) -> dict:
    """The probe runner's own cases (``mosaic_probe.cases(dev, shrink)``)
    of ``probe_ids``: "P3 cumsum axis=0" -> (kernel call, library call or
    None, library name, bound ms, what bounds it)."""
    from hashjoin3d_tpu_torch.tools import mosaic_probe
    from hashjoin3d_tpu_torch.utils.measure import bound_ms, nbytes

    out = {}
    for c in mosaic_probe.cases(dev, shrink):
        if c.probe in probe_ids:
            # a tree from before P4's u8 planes has no int8_ops: its bound
            # is its bytes', as here
            ms, by = bound_ms(nbytes(*c.inputs, c.run()),
                              getattr(c, "int8_ops", 0.0))
            out[f"{c.probe} {c.label}"] = (c.run, c.library, c.library_name,
                                           ms, by)
    return out


def probe_launch_costs(dev, probe_ids=LAUNCH_PROBES) -> dict:
    """Each case of :func:`probe_launch_cases`, its kernel and its library
    call: host and device µs per call (``host_device_us``), the device
    operations a call and their names (``device_ops``); the kernel's bound
    and its device share of it."""
    from hashjoin3d_tpu_torch.utils.measure import host_device_us

    res = {}
    for name, (run, library, lib_name, bound, by) in probe_launch_cases(
            dev, probe_ids).items():
        for side, fn in (("kernel", run), (lib_name, library)):
            if fn is None:
                continue
            host, device = host_device_us(fn)
            ops, names = device_ops(fn)
            res[f"{name} {side}"] = dict(host_us=host, device_us=device,
                                         device_ops=ops, device_op_names=names)
        k = res[f"{name} kernel"]
        k.update(bound_us=bound * 1e3, bound_by=by,
                 share_of_bound=bound * 1e3 / k["device_us"])
        if library is not None:
            k["device_vs_library"] = (k["device_us"]
                                      / res[f"{name} {lib_name}"]["device_us"])
    return res


def kernel_device_costs(dev) -> dict:
    """Host and device µs per call of K1, K2 with coverage, K2b, K4 2-op
    take_min and P7 at the inputs of ``times`` (R20/S24, W = 8192, 2^24
    words for P7)."""
    from hashjoin3d_tpu_torch.ops import bitonic, probes, windowed
    from hashjoin3d_tpu_torch.ops.layout import I32, from_numpy_u32
    from hashjoin3d_tpu_torch.utils.measure import host_device_us

    build, _, sa, _ = strands(dev)
    direct = build().direct
    sk, _ = bitonic.bitonic_sort_packed_segmented(sa, SEGMENT, KEY_BITS)
    n = 1 << LOG2_S
    lid = torch.arange(n, dtype=I32, device=dev) % SEGMENT
    wide = from_numpy_u32(np.random.default_rng(0).integers(
        0, (1 << LOG2_R) + (1 << 18), n, dtype=np.uint32), dev)
    src24 = torch.randint(0, 1 << 30, (n,), dtype=I32, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(3))
    calls = dict(
        k1=lambda: bitonic.bitonic_sort_packed_segmented(sa, SEGMENT,
                                                         KEY_BITS),
        k2_covered=lambda: windowed.windowed_lookup_covered(
            direct, sk, direct.shape[0], W=WINDOW),
        k2b=lambda: windowed.windowed_lookup(direct, sk, W=WINDOW, db=True),
        k4_2op=lambda: bitonic.bitonic_sort_segmented(
            wide, SEGMENT, payload=lid, stable=False),
        **{f"p7_{B}": lambda B=B: probes.block_copy(src24, B)
           for B in P7_BLOCKS})
    res = {}
    for name, fn in calls.items():
        res[f"{name}_host_us"], res[f"{name}_device_us"] = host_device_us(
            fn, calls=200, profiled=20)
    return res


def device_ops(fn, calls: int = 50) -> tuple[float, list[str]]:
    """Device operations (kernels, copies, sets) per call of ``fn`` under
    ``torch.profiler``, and their names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(ops) / calls, sorted(set(ops))


def times(side: str, dev) -> dict:
    from hashjoin3d_tpu_torch.ops import bitonic, probes, scan, windowed
    from hashjoin3d_tpu_torch.ops.hashing import bucket_of, hash_key
    from hashjoin3d_tpu_torch.ops.layout import I32, from_numpy_u32

    build, probe, sa, rk = strands(dev)
    k3 = k3_calls(rk)
    p5 = p5_cases(dev)
    n = 1 << LOG2_S
    lid = torch.arange(n, dtype=I32, device=dev) % SEGMENT
    wide = from_numpy_u32(np.random.default_rng(0).integers(
        0, (1 << LOG2_R) + (1 << 18), n, dtype=np.uint32), dev)
    dead = torch.from_numpy(np.random.default_rng(1).random(n) < 0.3).to(dev)
    ids = torch.where(dead, -1, bucket_of(hash_key(sa), 1 << LOG2_R))
    pay = torch.from_numpy(np.random.default_rng(2).integers(
        -2**15, 2**15, n, dtype=np.int32)).to(dev)
    sk, _ = bitonic.bitonic_sort_packed_segmented(sa, SEGMENT, KEY_BITS)
    direct = build().direct
    src8 = torch.arange(1 << 18, dtype=I32, device=dev).view(-1, 128)
    gen = torch.Generator(device=dev).manual_seed(3)
    src24 = torch.randint(0, 1 << 30, (n,), dtype=I32, device=dev,
                          generator=gen)
    return dict(
        side=side,
        k1_ms=events_ms(lambda: bitonic.bitonic_sort_packed_segmented(
            sa, SEGMENT, KEY_BITS)),
        k4_2op_ms=events_ms(lambda: bitonic.bitonic_sort_segmented(
            wide, SEGMENT, payload=lid, stable=False)),
        k4_1op_ms=events_ms(lambda: bitonic.bitonic_sort_segmented(
            ids, SEGMENT, unsigned=False)),
        k4_stable_ms=events_ms(lambda: bitonic.bitonic_sort_segmented(
            wide, SEGMENT, payload=pay)),
        k1_8192_ms=events_ms(lambda: bitonic.bitonic_sort_packed_segmented(
            sa, 8192, KEY_BITS)),
        k2_ms=events_ms(lambda: windowed.windowed_lookup(
            direct, sk, W=WINDOW)),
        k2b_ms=events_ms(lambda: windowed.windowed_lookup(
            direct, sk, W=WINDOW, db=True)),
        k2b_bit_equal=all(torch.equal(
            windowed.windowed_lookup(direct, keys, W=WINDOW, db=True),
            windowed.windowed_lookup_plain(direct, keys, W=WINDOW))
            for keys in (sk, torch.where(sk % 5 == 0, -1, sk))),
        **k2_times(direct, sk),
        index_select_ms=events_ms(lambda: torch.index_select(direct, 0, sk)),
        **{f"p7_{B}_ms": events_ms(lambda B=B: probes.block_copy(src24, B))
           for B in P7_BLOCKS},
        p7_bit_equal=all(torch.equal(probes.block_copy(src24, B), src24)
                         for B in P7_BLOCKS),
        clone_2_24_ms=events_ms(lambda: src24.clone()),
        p8_ms=events_ms(lambda: probes.row_copy(src8, 3)),
        clone_ms=events_ms(lambda: src8[3:11].clone()),
        **{f"{name}_ms": events_ms(lambda c=c: scan.multi_scan(*c), 200)
           for name, c in k3.items()},
        k3_bit_equal=all(
            all(torch.equal(g, w) for g, w in zip(scan.multi_scan(*c),
                                                  scan.multi_scan_plain(*c)))
            for c in k3.values()),
        **{f"p5_{C}_ms": events_ms(lambda x=x, p=p: probes.permute(x, p),
                                   200)
           for C, (x, p) in p5.items()},
        **{f"index_select_{C}_ms": events_ms(
            lambda x=x, p64=p.long(), C=C: torch.index_select(
                x.view(-1, C), 1, p64), 200)
           for C, (x, p) in p5.items()},
        p5_bit_equal=all(torch.equal(probes.permute(x, p),
                                     probes.permute_plain(x, p))
                         for x, p in p5.values()),
        build_ms_median=statistics.median(host_ms(build)),
        probe_ms_median=statistics.median(host_ms(probe)),
        **exp1_times(dev))


def k2_times(direct, sk) -> dict:
    """K2 with its coverage (where the tree has it) and ``safe_lookup`` on
    the K1-sorted S.a over the build's direct words at W = 8192, and
    whether K2's words, flags and count equal the plain version's."""
    from hashjoin3d_tpu_torch.ops import windowed
    from hashjoin3d_tpu_torch.ops.strands_windowed import safe_lookup

    res = dict(safe_lookup_ms=events_ms(lambda: safe_lookup(
        direct, sk, W=WINDOW)))
    if hasattr(windowed, "windowed_lookup_covered"):
        T = direct.shape[0]
        res["k2_covered_ms"] = events_ms(
            lambda: windowed.windowed_lookup_covered(direct, sk, T, W=WINDOW))
        res["k2_covered_bit_equal"] = all(
            all(torch.equal(g, w) for g, w in zip(
                windowed.windowed_lookup_covered(direct, keys, T, W=WINDOW),
                windowed.windowed_lookup_covered_plain(direct, keys, T,
                                                       W=WINDOW)))
            for keys in (sk, torch.roll(sk, 341)))
    return res


def exp1_times(dev) -> dict:
    """``t_buildStr`` and ``t_probeStr`` (ns) of ``Experiment1`` plan Csr at
    R20/S24, from its CSV row."""
    import csv
    import io

    from hashjoin3d_tpu_torch.models.exp1 import Experiment1

    buf = io.StringIO()
    exp = Experiment1(LOG2_R, LOG2_S, skew=False, t=0, b=1, plans=("Csr",),
                      measure_file=buf, device=dev)
    exp.init()
    exp.run()
    rows = list(csv.reader(io.StringIO(buf.getvalue()), delimiter=";"))
    row = dict(zip(rows[0], rows[1]))
    return {c: int(row[c]) for c in ("t_buildStr", "t_probeStr")}


def launch_costs(dev) -> dict:
    """Host microseconds per call of each launch-path step, and P8's and
    ``clone``'s host and device time per call."""
    import ctypes

    from hashjoin3d_tpu_torch import kernels
    from hashjoin3d_tpu_torch.ops import probes, scan
    from hashjoin3d_tpu_torch.ops.layout import from_numpy_u32
    from hashjoin3d_tpu_torch.utils.gen import exp1_data
    from hashjoin3d_tpu_torch.utils.measure import host_device_us

    src8 = torch.arange(1 << 18, dtype=torch.int32, device=dev).view(-1, 128)
    out = probes.row_copy(src8, 3)
    entry = kernels.lib().hj3t_probe_row_copy
    args = (src8.data_ptr(), out.data_ptr(), src8.shape[0], 3, 8)
    index = dev.index

    def us(fn, calls=10_000):
        fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us_per_call = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us_per_call

    steps = dict(
        current_stream_cuda_stream=lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        raw_stream=lambda: torch._C._cuda_getCurrentRawStream(index),
        c_void_p=lambda: ctypes.c_void_p(src8.data_ptr()),
        data_ptr=lambda: src8.data_ptr(),
        kernel_device=lambda: kernels.kernel_device("p", src8, align=16),
        torch_empty=lambda: torch.empty((8, 128), dtype=torch.int32,
                                        device=dev),
        new_empty=lambda: src8.new_empty((8, 128)),
        slice_rows=lambda: src8[3:11],
        ctypes_no_args=lambda: kernels.lib().hj3t_scan_tile(),
        entry_rejected=lambda: entry(*args[:4], 0, 0),
        entry_call=lambda: entry(*args, torch._C._cuda_getCurrentRawStream(
            index)))
    res = {f"{k}_us": us(fn) for k, fn in steps.items()}
    for name, fn in (("p8", lambda: probes.row_copy(src8, 3)),
                     ("clone", lambda: src8[3:11].clone())):
        res[f"{name}_host_us"], res[f"{name}_device_us"] = host_device_us(fn)
        for reps in (20, 2000):
            res[f"{name}_events_{reps}_us"] = events_ms(fn, reps) * 1e3
    rk = from_numpy_u32(exp1_data(LOG2_R, LOG2_S, False, 0)[0], dev)
    for name, c in k3_calls(rk).items():
        def fn(c=c):
            return scan.multi_scan(*c)
        res[f"{name}_host_us"], res[f"{name}_device_us"] = host_device_us(fn)
        res[f"{name}_device_ops"], res[f"{name}_device_op_names"] = (
            device_ops(fn))
        for reps in (10, 20, 2000):
            res[f"{name}_events_{reps}_us"] = events_ms(fn, reps) * 1e3
    for C, (x, p) in p5_cases(dev).items():
        p64 = p.long()
        for name, fn in ((f"p5_{C}", lambda x=x, p=p: probes.permute(x, p)),
                         (f"index_select_{C}",
                          lambda x=x, p64=p64, C=C: torch.index_select(
                              x.view(-1, C), 1, p64))):
            res[f"{name}_host_us"], res[f"{name}_device_us"] = (
                host_device_us(fn))
    return res


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
    here = Path(__file__).resolve().parents[1]
    t = sub.add_parser("times")
    t.add_argument("--side", required=True)
    t.add_argument("--root", type=Path, default=here)
    p = sub.add_parser("profile")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--root", type=Path, default=here)
    p.add_argument("--plans", default="Csr")
    la = sub.add_parser("launch")
    la.add_argument("--root", type=Path, default=here)
    la.add_argument("--probes", nargs="?", const=",".join(LAUNCH_PROBES),
                    help="only the probe section, for these comma-separated "
                         "probe ids (all of P1-P4, P6, P9 without a value)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_csr_perf: needs a CUDA GPU", file=sys.stderr)
        return 2
    root = args.root.resolve()
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
    elif args.mode == "launch":
        res = ({} if args.probes
               else {**launch_costs(dev), **kernel_device_costs(dev)})
        res["probes"] = probe_launch_costs(
            dev, (args.probes or ",".join(LAUNCH_PROBES)).split(","))
        print(json.dumps(res))
        for name, r in res["probes"].items():
            print(f"  {name:60s} device {r['device_us']:8.3f} us  host "
                  f"{r['host_us']:7.2f} us  ops {r['device_ops']:g}"
                  + (f"  share of bound {r['share_of_bound']:.3f}"
                     if "bound_us" in r else ""))
    else:
        for plan in args.plans.split(","):
            if plan in EXP4_PLANS:
                fns = exp4_strands(dev, plan)
            else:
                fns = dict(zip(("build", "probe"), (
                    strands(dev)[:2] if plan == "Csr"
                    else plan_strands(dev, plan))))
            for what, fn in fns.items():
                profile_strand(f"{plan} {what}", fn, args.reps)
            del fns
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
