"""The program's own spans and host-read counters, read per query.

The program (``hashjoin3d_tpu_torch.utils.tracing``) records a span at
each phase boundary of its builds (``hj.build`` and ``hj.build.*``), probe
strands (``hj.probe``, ``hj.probe.*``) and distributed exchange
(``hj.exchange``, ``hj.exchange.*``) while a ``torch.profiler`` window is
open, each with a CUDA event at both ends and the host reads made inside
it.  These are the records of this process: rank 0's, where the harness
runs.  The harness profiles one warm-up query in its set-up besides its
traced window; the window's records are those that start within the
window's length of the last record's end (the warm-up lies at least the
32 queries before the window earlier, and on a mesh it waits for the
other ranks' profilers to start).  Every query of every cell runs one
probe strand, so a query is a total over the window's records divided by
their ``hj.probe`` roots.

On a program that keeps no such records every reader returns None.
"""

from __future__ import annotations

PROBE_ROOT = "hj.probe"


def records():
    """The program's span records, or None where it keeps none."""
    try:
        from hashjoin3d_tpu_torch.utils import tracing
    except ImportError:
        return None
    read = getattr(tracing, "records", None)
    return read() if read is not None else None


def _window(run):
    """``(every record, the traced window's records)``, or None without a
    trace or a probe root in the window."""
    if run.trace is None:
        return None
    recs = records()
    if not recs:
        return None
    end = max(r.t1_ns for r in recs if r.t1_ns is not None)
    start = end - run.trace.window_s * 1e9
    window = [r for r in recs if r.t0_ns >= start]
    if not any(r.name == PROBE_ROOT for r in window):
        return None
    return recs, window


def _queries(recs) -> int:
    return sum(1 for r in recs if r.name == PROBE_ROOT)


def _root(recs, rec):
    while rec.parent >= 0:
        rec = recs[rec.parent]
    return rec


def _within(name: str, span: str) -> bool:
    return name == span or name.startswith(span + ".")


def span_ms(run, names, outside: str | None = None):
    """Stream ms a query of the records named in ``names``, leaving out
    those with an ancestor named ``outside``; None without a trace, a
    probe root, such a record or its events.

    Each record is timed between the CUDA events recorded at its ends:
    the stream's time from one host boundary to the next under the
    profiler, the card's idle time while the profiled host issues the
    phase included.  Where the host is slower than the card (Csr's and
    Nrs's builds and probes) most of it is the host's time; it is not the
    phase's busy time on the card."""
    got = _window(run)
    if got is None:
        return None
    recs, window = got
    total, found = 0.0, False
    for r in window:
        if r.name not in names:
            continue
        up, skip = r, False
        while outside is not None and up.parent >= 0:
            up = recs[up.parent]
            skip = skip or up.name == outside
        if skip:
            continue
        ms = r.device_ms()
        if ms is None:
            return None
        total, found = total + ms, True
    return total / _queries(window) if found else None


def host_reads(run, roots=("hj.build", "hj.probe")):
    """Host reads a query counted inside the ``roots`` spans; None without
    a trace or a probe root."""
    got = _window(run)
    if got is None:
        return None
    recs, window = got
    n = sum(sum(r.reads.values()) for r in window
            if _root(recs, r).name in roots)
    return n / _queries(window)


def glue_idle_ms(run, span: str):
    """Idle ms of the card a query (the profiler's gaps) while the host's
    innermost event was ``span`` or one of its children: the program's own
    Python between two device operations.  None without a trace or where
    the program opened no such span."""
    if run.trace is None or run.trace.queries == 0:
        return None
    recs = records()
    if not recs or not any(r.name == span for r in recs):
        return None
    s = sum(v for k, v in run.trace.idle_gaps.items() if _within(k, span))
    return s / run.trace.queries * 1e3
