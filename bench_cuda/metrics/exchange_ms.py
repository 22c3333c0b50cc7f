"""Stream ms a query of the distributed exchange: the program's
``hj.exchange`` spans (route, pack, all-to-all) and the
``hj.exchange.reduce`` spans outside them (the counters' all-reduce).
Timed between rank 0's CUDA events at the spans' ends on the profiled
host (``program_trace.span_ms``)."""

from ..program_trace import span_ms


def read(run):
    return span_ms(run, ("hj.exchange", "hj.exchange.reduce"),
                   outside="hj.exchange")
