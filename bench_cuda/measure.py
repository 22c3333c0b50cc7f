"""The benchmark's arithmetic: rates and tails over a window, the card's
peaks, and the reduction of a ``torch.profiler`` trace to busy time,
kernel time by name, host reads and idle gaps.

The peak and the busy-time union follow the port's own tools
(``hashjoin3d_tpu_torch/utils/measure.py`` ``bound_ms``,
``tools/torch_csr_perf.py`` ``busy_us``); they are written again here so
that no later change to the program can move the yardstick.
"""

from __future__ import annotations

import math
import re
import subprocess
from collections import defaultdict
from dataclasses import dataclass, field

#: NVIDIA H100 SXM (80 GB HBM3) device memory rate, bytes/s, from NVIDIA's
#: data sheet at the card's full 700 W power limit.  A card set below it
#: reads lower shares; every run prints the card's limit beside its numbers.
HBM_BYTES_PER_S = 3.35e12

#: host-side calls that wait for the device: the syncs and the blocking
#: copies a read of a device value makes
HOST_READS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def bound_ms(n_bytes: float) -> float:
    """The least time the card could move ``n_bytes`` in, ms."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def rate(work_per_query: float, queries: int, window_s: float) -> float:
    """All the work of the window over all its time."""
    return work_per_query * queries / window_s


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile over every value: the smallest
    value with at least ``q`` percent of the values at or below it."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    k = max(math.ceil(q / 100 * len(s)), 1)
    return s[k - 1]


def median(values) -> float:
    s = sorted(values)
    m = len(s) // 2
    return s[m] if len(s) % 2 else (s[m - 1] + s[m]) / 2


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


def smi() -> list[str]:
    """One line a card: index, name, SM and memory clocks, power draw and
    limit, temperature (``nvidia-smi``); empty where it cannot run."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,clocks.sm,clocks.mem,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return r.stdout.strip().splitlines() if r.returncode == 0 else []


def kernel_matches(name: str, kernels) -> bool:
    """Whether a device operation's name is one of ``kernels``: a listed
    identifier as a whole word of the (demangled) name, or a prefix of a
    word when it ends in ``*``."""
    for k in kernels:
        pat = (rf"\b{re.escape(k[:-1])}" if k.endswith("*")
               else rf"\b{re.escape(k)}\b")
        if re.search(pat, name):
            return True
    return False


@dataclass
class Trace:
    """A traced span of ``queries`` whole queries on one card."""

    queries: int
    window_s: float
    busy_s: float
    #: device operation name -> (seconds, count)
    device_ops: dict = field(default_factory=dict)
    host_reads: int = 0
    #: host operation -> idle seconds of the card while it ran
    idle_gaps: dict = field(default_factory=dict)

    def kernel_s(self, kernels) -> float:
        """Device seconds of the operations named by ``kernels``."""
        return sum(s for n, (s, _) in self.device_ops.items()
                   if kernel_matches(n, kernels))

    def breakdown(self) -> dict:
        top = sorted(self.device_ops.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, (s, _) in top],
                "idle_gaps": [[n[:120], s] for n, s in gaps]}


def _innermost(points, spans):
    """For each sorted point, the name of the innermost host span covering
    it (spans ``(start, end, name)`` sorted by start, nested as one
    thread's calls are), or ``"(between host calls)"``."""
    out, stack, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else "(between host calls)")
    return out


def reduce_profile(prof, queries: int, window_s: float) -> Trace:
    """Busy time (the union of kernel, copy and memset intervals), device
    time by operation, host reads and idle gaps of a finished
    ``torch.profiler.profile`` over ``queries`` queries."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    # annotations on the device's timeline (a collective's ``nccl:<op>``)
    # span the kernels they name: they are no operations of their own
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith("nccl:")]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    iv = sorted((e.time_range.start, e.time_range.end) for e in dev)
    ops = defaultdict(lambda: [0.0, 0])
    for e in dev:
        ops[e.name][0] += e.time_range.elapsed_us() / 1e6
        ops[e.name][1] += 1
    reads = sum(1 for e in host if e.name in HOST_READS)
    # idle gaps between merged device intervals, named by the host call
    # that ran through each gap's middle on the launching thread
    gaps, reach = [], None
    for s, e in iv:
        if reach is not None and s > reach:
            gaps.append((reach, s))
        reach = e if reach is None else max(reach, e)
    by_thread = defaultdict(list)
    for e in host:
        by_thread[e.thread].append((e.time_range.start, e.time_range.end,
                                    e.name))
    spans = sorted(max(by_thread.values(), key=len)) if by_thread else []
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    idle = defaultdict(float)
    for name, (_, length) in zip(_innermost([m for m, _ in mids], spans),
                                 mids):
        idle[name] += length / 1e6
    return Trace(queries=queries, window_s=window_s,
                 busy_s=busy_us(iv) / 1e6,
                 device_ops={k: (v[0], v[1]) for k, v in ops.items()},
                 host_reads=reads, idle_gaps=dict(idle))
