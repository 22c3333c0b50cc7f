"""Device ms from a query's ``probe`` mark to its end (CUDA events), the
median over the window's queries outside the traced span."""

from .. import measure


def read(run):
    ms = run.phase_ms.get("probe")
    return measure.median(ms) if ms else None
