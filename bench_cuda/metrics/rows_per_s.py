"""Build and probe rows of every query completed in the window (the
traffic's ``rows`` relations, global on a mesh), over the window's whole
time."""

from .. import measure


def read(run):
    rows = sum(run.config["rows"][r] for r in run.traffic["rows"])
    return measure.rate(rows, run.queries, run.window_s)
