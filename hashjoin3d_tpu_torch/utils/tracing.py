"""Tracing, timing and runtime checks.

Port of ``hashjoin3d_tpu/utils/tracing.py``, the counterparts of the
reference's observability tools:

* its gprof build mode (``makefile:49-52``) -> :func:`trace`, a
  ``torch.profiler`` window that writes a Chrome trace (Perfetto,
  ``chrome://tracing``);
* its per-operator steady-clock timers (``algebra.hh:176-199``) ->
  :class:`DeviceTimer`, which waits for the output's device before it
  stops the clock;
* its ASan/UBSan build mode (``makefile:56-58``) -> :func:`checked`, which
  runs a function, synchronises, and returns a device assert, an index
  error or a NaN in a float output as an error object instead of raising.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


def _tensors(obj):
    """Every tensor in a (nested) output, with its path."""
    if isinstance(obj, torch.Tensor):
        yield "", obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            for p, t in _tensors(v):
                yield f"[{k!r}]{p}", t
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            for p, t in _tensors(v):
                yield f"[{i}]{p}", t
    elif hasattr(obj, "__dataclass_fields__"):
        for k in obj.__dataclass_fields__:
            for p, t in _tensors(getattr(obj, k)):
                yield f".{k}{p}", t


def _sync(out) -> None:
    """Wait for every CUDA device an output's tensors lie on."""
    for dev in {t.device for _, t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def trace(log_dir):
    """Profile the enclosed block (CPU, and CUDA where there is a card)
    and write ``log_dir/trace.json``, a Chrome trace; yields the profiler
    (``key_averages()`` gives the per-kernel sums)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


class DeviceTimer:
    """Wall-clock calls of a function up to the end of their device work:
    ``timer(fn, *args)`` runs ``fn``, waits for the devices its output
    lies on, and adds the time to ``total``."""

    def __init__(self):
        self.total = 0.0
        self.calls = 0

    def __call__(self, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(out)
        self.total += time.perf_counter() - t0
        self.calls += 1
        return out

    @property
    def mean(self) -> float:
        return self.total / max(self.calls, 1)


class CheckError:
    """What :func:`checked` caught: ``get()`` its message (None when the
    call was clean), ``throw()`` raises it."""

    def __init__(self, exc: BaseException | None = None):
        self.exc = exc

    def get(self) -> str | None:
        return None if self.exc is None else str(self.exc)

    def throw(self) -> None:
        if self.exc is not None:
            raise self.exc


def checked(fn):
    """``fn`` wrapped to return ``(err, out)``: it runs ``fn``, waits for
    its output's devices, and records in ``err`` an index error or a device
    assert (``out`` None then) or a NaN in a float output.

    Example::

        err, table = checked(build_nested)(keys, 64)
        err.throw()   # raises on an out-of-range index, an assert or a NaN
    """

    def wrapper(*args, **kwargs):
        try:
            out = fn(*args, **kwargs)
            _sync(out)
        except (IndexError, RuntimeError) as e:
            return CheckError(e), None
        for path, t in _tensors(out):
            if t.is_floating_point() and bool(torch.isnan(t).any()):
                return CheckError(FloatingPointError(
                    f"nan generated in the output{path}")), out
        return CheckError(), out

    return wrapper
