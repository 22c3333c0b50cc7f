"""The sorted keys' table lookup against its bound: the table read once,
the keys read and one word a key written, over the memory rate, in the
device time of the kernels the traffic lists under ``ops.lookup``."""

from . import roofline_pct


def read(run):
    return roofline_pct(run, "lookup")
