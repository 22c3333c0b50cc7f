"""The reference's repetition protocol on the GPU's clock.

``repeat_mintime`` reproduces ``util/measure_helpers.hh:15-41``: run the
closure, doubling the planned repetition count whenever the cumulative time
is still under ``min_time_s`` at the end of the plan, never fewer than
``min_repeat`` runs.  Each run is timed on the host clock between two
``torch.cuda.synchronize()`` calls (no-ops for a CPU device), so the time is
the device's work for that run, not its enqueue.

The measurement tools (``tools/roofline.py``, ``tools/csrprof.py``,
``tools/mosaic_probe.py``) time on CUDA events with :func:`events_ms`, name
the card with :func:`card`, and state each bound with :func:`bound_ms`;
:func:`host_device_us` splits a small call's time into its host and device
parts.  :class:`Timers` are the harness's named start/stop timers
(``--print-timers``).
"""

from __future__ import annotations

import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

#: H100 SXM device memory rate, bytes/s (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense int8 tensor-core rate, operations/s (NVIDIA's data sheet)
INT8_OPS = 1979e12


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op for the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def repeat_mintime(min_time_s: float, func, device: torch.device,
                   min_repeat: int = 1):
    """Returns ``(total_seconds, n_reps, last_result)``."""
    n = min_repeat
    total = 0.0
    i = 0
    out = None
    while i < n:
        sync(device)
        t0 = time.perf_counter()
        out = func()
        sync(device)
        total += time.perf_counter() - t0
        if i == n - 1 and total < min_time_s:
            n *= 2
        i += 1
    return total, n, out


@dataclass
class Timers:
    """Named start/stop experiment timers on the host clock
    (``main_experiment1.cc:199-201,1349-1359``)."""

    points: dict = field(default_factory=dict)

    def start(self, desc: str) -> None:
        self.points[desc] = [time.perf_counter(), None]

    def stop(self, desc: str) -> None:
        self.points[desc][1] = time.perf_counter()

    def print(self, out=None) -> None:
        out = out or sys.stdout
        for desc, (t0, t1) in sorted(self.points.items()):
            end = t1 if t1 is not None else time.perf_counter()
            out.write(f"  {desc}|{(end - t0) * 1e3:.3f} ms\n")


def require_cuda() -> torch.device:
    """The device of a measurement: the first CUDA GPU.  A measurement never
    falls back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("this measurement needs a CUDA GPU "
                           "(torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def events_ms(fn, min_time_s: float) -> float:
    """Mean milliseconds per call of ``fn`` on CUDA events: one warm-up
    call, then runs of 3 calls, doubling (or more) until one run of calls
    takes at least ``min_time_s``."""
    fn()
    torch.cuda.synchronize()
    reps = 3
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        if ms >= min_time_s * 1e3:
            return ms / reps
        reps = max(2 * reps, int(reps * min_time_s * 1e3 / max(ms, 1e-3)) + 1)


def host_device_us(fn, calls: int = 10_000,
                   profiled: int = 200) -> tuple[float, float]:
    """``(host, device)`` microseconds per call of ``fn``: the host's
    ``time.perf_counter`` over ``calls`` calls issued back to back with no
    synchronisation, and the device time of every kernel and copy the
    calls run, under ``torch.profiler`` over ``profiled`` calls.  A call
    whose host time exceeds its device time is host-bound: back-to-back
    CUDA-event timing (:func:`events_ms`) then reads its host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            fn()
        torch.cuda.synchronize()
    device = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    return host, device / profiled


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: int, int8_ops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take: the larger of ``n_bytes`` over
    the memory rate and ``int8_ops`` over the tensor cores' int8 rate;
    and which of the two bounds."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = int8_ops / INT8_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
