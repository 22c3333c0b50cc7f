"""Stream ms a query of the program's ``hj.probe.sort`` spans: the probe
order (sort, inverse permutation or presorted pass-through). Timed
between the CUDA events at the spans' ends on the profiled host
(``program_trace.span_ms``), so a host-bound phase reads the host's
time."""

from ..program_trace import span_ms


def read(run):
    return span_ms(run, ("hj.probe.sort",))
