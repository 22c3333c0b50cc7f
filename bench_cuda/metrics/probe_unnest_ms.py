"""Stream ms a query of the program's ``hj.probe.unnest`` spans: the
expansions and the row lookups after them. Timed between the CUDA events
at the spans' ends on the profiled host (``program_trace.span_ms``), so
a host-bound phase reads the host's time."""

from ..program_trace import span_ms


def read(run):
    return span_ms(run, ("hj.probe.unnest",))
