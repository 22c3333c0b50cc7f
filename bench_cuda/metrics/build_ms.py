"""Device ms from a query's ``build`` mark to its next mark (CUDA
events), the median over the window's queries outside the traced span."""

from .. import measure


def read(run):
    ms = run.phase_ms.get("build")
    return measure.median(ms) if ms else None
