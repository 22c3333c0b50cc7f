"""Stream ms a query of the program's ``hj.probe.walk`` spans: the
whole-chain walk of every live probe of a chaining probe without early
exit (``_full_chain_cmps``: hash, the bucket ids' sort, the chain-length
lookup and sum). Timed between the CUDA events at the spans' ends on the
profiled host (``program_trace.span_ms``), so a host-bound phase reads
the host's time."""

from ..program_trace import span_ms


def read(run):
    return span_ms(run, ("hj.probe.walk",))
