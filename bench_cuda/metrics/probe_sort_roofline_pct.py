"""The probe keys' sort against its bound: 12 bytes a key (read the key,
write the key and its row) over the memory rate, in the device time of
the kernels the traffic lists under ``ops.probe_sort``."""

from . import roofline_pct


def read(run):
    return roofline_pct(run, "probe_sort")
