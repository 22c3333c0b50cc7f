"""The reference's repetition protocol on the GPU's clock.

``repeat_mintime`` reproduces ``util/measure_helpers.hh:15-41``: run the
closure, doubling the planned repetition count whenever the cumulative time
is still under ``min_time_s`` at the end of the plan, never fewer than
``min_repeat`` runs.  Each run is timed on the host clock between two
``torch.cuda.synchronize()`` calls (no-ops for a CPU device), so the time is
the device's work for that run, not its enqueue.
"""

from __future__ import annotations

import time

import torch


def _sync(device: torch.device) -> None:
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
        _sync(device)
        t0 = time.perf_counter()
        out = func()
        _sync(device)
        total += time.perf_counter() - t0
        if i == n - 1 and total < min_time_s:
            n *= 2
        i += 1
    return total, n, out
