"""Tracing, program spans, host-read counters and runtime checks.

Port of ``hashjoin3d_tpu/utils/tracing.py``, the counterparts of the
reference's observability tools:

* its gprof build mode (``makefile:49-52``) -> :func:`trace`, a
  ``torch.profiler`` window that writes a Chrome trace (Perfetto,
  ``chrome://tracing``);
* its per-operator steady-clock timers (``algebra.hh:176-199``) ->
  :func:`span`, opened at each phase boundary of the builds, the probe
  strands and the distributed exchange (``hj.build``, ``hj.probe``,
  ``hj.exchange`` and their ``hj.<root>.<phase>`` children), and
  :func:`host_read`, each device-to-host read of those paths counted by
  site;
* its ASan/UBSan build mode (``makefile:56-58``) -> :func:`checked`, which
  runs a function, synchronises, and returns a device assert, an index
  error or a NaN in a float output as an error object instead of raising.

Spans are on exactly while a ``torch.profiler`` window is open (the
benchmark's traced window, or :func:`trace`); otherwise :func:`span`
returns a shared no-op.  An open span is a profiler range (a
``record_function`` without its operator), so it lies on the profiler's
timeline with the device's operations, and it appends a
:class:`SpanRecord` to an in-memory list (:func:`records`): host times, a
CUDA event at each end where CUDA is in use, and the host reads made
inside it.  Reads are counted only there: off, :func:`host_read` is the
bare read.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

#: records kept at most; spans past it still enter the profiler's
#: timeline but make no record
MAX_RECORDS = 1 << 17
#: timing events a device's pool makes at once.  The profiler traces every
#: CUDA runtime call, so making an event inside a span costs as much again
#: as recording it; a pool of this size, made at the first span of a
#: process, lasts a traced window of 32 queries in every cell.
EVENT_BATCH = 4096
#: the profiler's range without the dispatcher's operator
#: (``record_function``'s own), where this build of torch has it
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.autograd.profiler.record_function)


class SpanRecord:
    """One span: its ``name``, the index of its parent in
    :func:`records` (-1 for a root), host ``perf_counter_ns`` at its ends,
    a CUDA event at each end (None where CUDA is not in use), and the
    host reads made directly inside it, by site (``reads``).

    A span with children launches no device work of its own: its children
    tile it.  So one event marks each boundary: a child starts at its
    parent's start or at the previous child's end, and a parent ends at
    its last child's end.  A recorded event costs the profiled host tens
    of microseconds, so this halves what spans add to a traced query."""

    __slots__ = ("name", "parent", "index", "t0_ns", "t1_ns", "ev0", "ev1",
                 "reads", "mark", "nested")

    def __init__(self, name: str, parent: int, index, ev0):
        self.name, self.parent, self.index = name, parent, index
        self.t1_ns = self.ev1 = None
        self.reads: dict = {}
        #: the last boundary inside the span: its start or a child's end
        self.ev0 = self.mark = ev0
        self.nested = False
        self.t0_ns = time.perf_counter_ns()

    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6

    def device_ms(self) -> float | None:
        """Device ms between the span's two events (it waits for the
        second); None without events."""
        if self.ev0 is None or self.ev1 is None:
            return None
        self.ev1.synchronize()
        return self.ev0.elapsed_time(self.ev1)


_records: list = []
#: the open spans, innermost last
_open: list = []
#: CUDA device index -> timing events made and not yet handed out
_pools: dict = {}


def _event():
    """A timing event recorded on the current CUDA stream, or None where
    this process has not started CUDA."""
    if not torch.cuda.is_initialized():
        return None
    pool = _pools.setdefault(torch.cuda.current_device(), [])
    if not pool:
        for _ in range(EVENT_BATCH):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()  # CUDA makes the event at its first record
            pool.append(ev)
    ev = pool.pop()
    ev.record()
    return ev


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "rf", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = _RANGE(self.name)
        self.rf.__enter__()
        outer = _open[-1] if _open else None
        parent = -1 if outer is None else outer.index
        full = len(_records) >= MAX_RECORDS or parent is None
        rec = SpanRecord(self.name, parent, None if full else len(_records),
                         _event() if outer is None else outer.mark)
        if not full:
            _records.append(rec)
        _open.append(rec)
        self.rec = rec
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.t1_ns = time.perf_counter_ns()
        rec.ev1 = rec.mark if rec.nested else _event()
        _open.pop()
        if _open:
            _open[-1].mark, _open[-1].nested = rec.ev1, True
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one phase, named ``name``.  Off (no
    profiler window open) it is a shared no-op; on, a profiler range
    named ``name`` and a :class:`SpanRecord`.  A span
    whose name is already open (a build entry point calling another)
    opens nothing, so each route opens its root once."""
    if not torch.autograd._profiler_enabled():
        return _NOOP
    for rec in _open:
        if rec.name == name:
            return _NOOP
    return _Span(name)


def host_read(t: torch.Tensor, site: str):
    """``t.item()``; while a span is open, counted under ``site`` in the
    innermost one's record."""
    if _open:
        reads = _open[-1].reads
        reads[site] = reads.get(site, 0) + 1
    return t.item()


def records() -> list:
    """The span records made since the last :func:`clear`, in the order
    the spans opened."""
    return list(_records)


def clear() -> None:
    """Drop every record (call it outside any open span)."""
    _records.clear()


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
