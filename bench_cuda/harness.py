"""One run of one cell: set-up, the measured window, the check.

Set-up makes the traffic's ``instances`` data instances on the device from
the seed (the configuration's recipe), hands each to the entry, and runs
one query on each, so that every shape the window uses is built, compiled
and allocated before it opens.  The window is a closed loop with one
client: the next query starts when the previous one's counters are on the
host, and queries cycle through the instances, so that no query finds its
inputs in the card's L2 cache from the one before.  Each query is timed
on the host clock from the call of its first phase to its counters on the
host.

With ``trace`` the same window records CUDA events at each phase mark and
profiles ``TRACE_QUERIES`` queries from query ``TRACE_FROM`` on, and the
run reports the per-layer metrics; without it, the end-to-end metrics.

After the window the program's state is freed and the plain reference
works every instance's join out again from the same seed: every query's
counters, and the result rows of one query an instance drawn from the
seed, are compared with it.  On several ranks, every rank runs this loop
with its own blocks; rank 0 decides when the window closes and gathers
the rows to judge.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import measure, spec
from .recipes import instance_seed

#: the traced span of a ``--trace 1`` run, in queries
TRACE_FROM, TRACE_QUERIES = 32, 32
#: the judged queries: one an instance, drawn from its first rounds (all
#: before the traced span)
SAMPLE_ROUNDS = 8


@dataclass
class Context:
    """What an entry sees of the run."""

    config: dict
    traffic: dict
    device: torch.device
    rank: int = 0
    world: int = 1
    #: objects an entry builds once for all instances (a mesh, a step)
    shared: dict = field(default_factory=dict)


@dataclass
class Run:
    """What a metric's reader sees of the run (rank 0's view; ``busy``
    and ``peak_bytes`` cover every rank)."""

    config: dict
    traffic: dict
    world: int
    queries: int
    window_s: float
    setup_s: float
    latencies_s: list
    peak_bytes: int
    #: phase -> device ms of that phase, a query (traced span left out)
    phase_ms: dict = field(default_factory=dict)
    trace: measure.Trace | None = None
    #: (busy_s, traced window_s) of each rank's traced span
    busy: list = field(default_factory=list)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sample_queries(seed: int, instances: int) -> dict:
    """Query index -> instance of the judged queries."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [abs(seed), int(seed < 0), 1 << 20]))
    rounds = rng.integers(0, SAMPLE_ROUNDS, size=instances)
    return {int(r) * instances + i: i for i, r in enumerate(rounds)}


class _Marks:
    """CUDA events at an entry's phase marks (none on the CPU)."""

    def __init__(self, on: bool):
        self.on = on
        self.queries = []

    def start(self):
        self.cur = []
        return self.mark if self.on else (lambda phase: None)

    def mark(self, phase) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.cur.append((phase, ev))

    def finish(self, keep: bool) -> None:
        if self.on and keep:
            self.queries.append(self.cur)

    def phase_ms(self) -> dict:
        out = {}
        for marks in self.queries:
            per = {}
            for (phase, a), (_, b) in zip(marks, marks[1:]):
                per[phase] = per.get(phase, 0.0) + a.elapsed_time(b)
            for phase, ms in per.items():
                out.setdefault(phase, []).append(ms)
        return out


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _read(entry, out):
    """The query's counters on the host (the loop's one read) and its
    route."""
    c = entry.counters(out)
    vec = torch.stack([v.to(torch.int64).reshape(()) for v in c.values()])
    return dict(zip(c, vec.cpu().tolist())), entry.route(out)


def _agree_stop(stop: bool, device) -> bool:
    """Rank 0's decision, on every rank."""
    import torch.distributed as dist

    flag = torch.tensor([int(stop)], dtype=torch.int32, device=device)
    dist.broadcast(flag, 0)
    return bool(flag.item())


def _gather_rows(rows: dict, world: int) -> dict:
    """Every rank's result rows, concatenated in rank order."""
    import torch.distributed as dist

    out = {}
    for k, v in rows.items():
        parts = [torch.empty_like(v) for _ in range(world)]
        dist.all_gather(parts, v.contiguous())
        out[k] = torch.cat(parts)
    return out


def _all_max(x: float, device) -> float:
    import torch.distributed as dist

    t = torch.tensor([x], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _all_pairs(a: float, b: float, world: int, device) -> list:
    import torch.distributed as dist

    t = torch.tensor([a, b], dtype=torch.float64, device=device)
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t)
    return [tuple(p.tolist()) for p in parts]


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, rank: int = 0, world: int = 1):
    """Run ``cell`` once; rank 0 returns ``(Run, checks, attempted,
    failed)``, the other ranks None."""
    cfg, traffic = cell.config, cell.traffic
    ctx = Context(cfg, traffic, device, rank, world)
    recipe = spec.module("recipes", cfg["recipe"])
    entry = spec.module("entries", traffic["entry"])
    ref = spec.module("references", traffic["reference"])
    n_inst = int(traffic["instances"])
    say = log if rank == 0 else (lambda m: None)

    if device.type == "cuda":
        from hashjoin3d_tpu_torch import kernels
        kernels.lib()
    states = []
    for i in range(n_inst):
        cols = recipe.columns(cfg, instance_seed(seed, i), device)
        states.append(entry.prepare(ctx, cols))
        del cols
    for st in states:  # warm-up: every shape the window uses
        _read(entry, entry.query(st, lambda phase: None))
    if trace:  # the profiler's first start is slow: make it here
        with _profiler(device):
            _read(entry, entry.query(states[0], lambda phase: None))
    _sync(device)
    # what set-up made stays: keep the collector from walking it in the
    # window
    gc.collect()
    gc.freeze()
    sample = sample_queries(seed, n_inst)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    smi_before = measure.smi() if rank == 0 else []
    marks = _Marks(trace and device.type == "cuda")
    lat, counts, kept = [], [], {}
    raised = failed = 0
    prof = None
    t_traced = traced = 0

    def end_trace():
        """Close the traced span: its length, then the profiler."""
        _sync(device)
        span = time.perf_counter() - t_traced
        prof.__exit__(None, None, None)
        return span

    start = time.perf_counter()
    setup_s = start - t_start
    deadline = start + seconds
    q = 0
    while True:
        if trace and q == TRACE_FROM:
            prof = _profiler(device)
            prof.__enter__()
            t_traced = time.perf_counter()
        inst = q % n_inst
        mark = marks.start()
        t0 = time.perf_counter()
        try:
            out = entry.query(states[inst], mark)
            vals, worst = _read(entry, out)
        except Exception as exc:  # a query that raises counts as failed
            if world > 1:
                raise
            log(f"query {q} raised {type(exc).__name__}: {exc}")
            raised += 1
            out, vals, worst = None, None, 0
        lat.append(time.perf_counter() - t0)
        in_trace = prof is not None and traced < TRACE_QUERIES
        marks.finish(keep=not in_trace)
        counts.append((inst, vals))
        failed += (vals is None or worst != 0
                   or vals.get("overflow", 0) != 0)
        if q in sample and out is not None:
            kept[q] = ({k: v.cpu() for k, v in entry.rows(out).items()},
                       vals)
        del out
        if in_trace:
            traced += 1
            if traced == TRACE_QUERIES:
                t_traced = end_trace()
        q += 1
        # a traced run closes its window after the traced span
        stop = (time.perf_counter() >= deadline
                and (not trace or traced >= TRACE_QUERIES))
        if world > 1:
            stop = _agree_stop(stop, device)
        if stop:
            break
    window_s = time.perf_counter() - start
    if prof is not None and traced < TRACE_QUERIES:
        t_traced = end_trace()

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    smi_after = measure.smi() if rank == 0 else []
    phase_ms = marks.phase_ms()
    del states, marks
    ctx.shared.clear()
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tr = (measure.reduce_profile(prof, traced, t_traced)
          if prof is not None else None)
    busy = [(tr.busy_s, tr.window_s)] if tr is not None else []
    if world > 1:
        peak = int(_all_max(float(peak), device))
        if tr is not None:
            busy = _all_pairs(tr.busy_s, tr.window_s, world, device)
    for line in smi_before:
        say(f"nvidia-smi before the window: {line}")
    for line in smi_after:
        say(f"nvidia-smi after the window: {line}")
    say(f"window: {q} queries in {window_s:.3f} s after {setup_s:.3f} s "
        f"of set-up; {failed} failed, {raised} of them raised")
    say("query ms, min / p5 / p50 / p95 / p99 / max: " + " / ".join(
        f"{measure.percentile(lat, p) * 1e3:.4f}" if p else
        f"{min(lat) * 1e3:.4f}" for p in (0, 5, 50, 95, 99, 100)))
    for i in range(n_inst):
        mine = lat[i::n_inst]
        say(f"instance {i}: p50 {measure.percentile(mine, 50) * 1e3:.4f} "
            f"p95 {measure.percentile(mine, 95) * 1e3:.4f} ms")

    if rank != 0:
        for q in _judged(sample, kept, n_inst):  # rank 0 judges them
            _gather_rows({k: v.to(device) for k, v in kept[q][0].items()},
                         world)
        return None
    checks = _check(ref, recipe, cfg, traffic, seed, device, n_inst,
                    counts, kept, sample, raised, world)
    return (Run(config=cfg, traffic=traffic, world=world, queries=q,
                window_s=window_s, setup_s=setup_s, latencies_s=lat,
                peak_bytes=int(peak), phase_ms=phase_ms, trace=tr,
                busy=busy),
            checks, q, failed)


def _judged(sample, kept, n_inst, only=None):
    """The judged queries that came (of instance ``only``, or all), in the
    order every rank walks them."""
    for inst in range(n_inst) if only is None else (only,):
        for q, i in sorted(sample.items()):
            if i == inst and q in kept:
                yield q


def _check(ref, recipe, cfg, traffic, seed, device, n_inst, counts, kept,
           sample, raised, world) -> dict:
    """The compared numbers: the worst over every query's counters and the
    judged queries' rows, ``answers_missing`` (judged queries that never
    came, or raised) and ``overflow`` (queries whose path dropped rows)."""
    worst = {k: 0 for k in ref.LIMITS}
    missing = raised + sum(1 for q in sample if q not in kept)
    overflow = 0
    for inst in range(n_inst):
        cols = recipe.columns(cfg, instance_seed(seed, inst), device)
        expected = ref.expect(cols, cfg, traffic)
        for i, vals in counts:
            if i != inst or vals is None:
                continue
            overflow = max(overflow, int(vals.get("overflow", 0)))
            for name in ref.COUNTERS:
                gap = abs(int(vals[name]) - expected[name])
                worst[f"{name}_gap"] = max(worst[f"{name}_gap"], gap)
        for q in _judged(sample, kept, n_inst, inst):
            rows, vals = kept[q]
            rows = {k: v.to(device) for k, v in rows.items()}
            if world > 1:
                rows = _gather_rows(rows, world)
            numbers = ref.judge(cols, dict(rows, counters=vals), expected,
                                traffic)
            for k, v in numbers.items():
                worst[k] = max(worst[k], v)
        del cols
    worst["answers_missing"] = missing
    worst["overflow"] = overflow
    return worst


def limits(ref) -> dict:
    return dict(ref.LIMITS, answers_missing=0, overflow=0)
