"""The 95th percentile (nearest rank) over every query of the window, each
timed on the host clock from its first call to its counters on the host;
on a mesh, rank 0's, which the step's collectives hold to the slowest
rank."""

from .. import measure


def read(run):
    return measure.percentile(run.latencies_s, 95) * 1e3
