"""Device ms a query of the windowed lookups' re-gathers: the program's
``lookup.regather`` timed site (``tracing.timed`` in ``safe_lookup``,
the patch of the uncovered chunks or the plain gather of the whole
stream), summed over the records under the ``hj.build`` and ``hj.probe``
roots of the traced window.  0 where no query re-gathers; None without a
trace, a probe root, the site's device events, or on a program that keeps
no timed sites."""

from ..program_trace import _queries, _root, _window

ROOTS = ("hj.build", "hj.probe")
SITE = "lookup.regather"


def read(run):
    got = _window(run)
    if got is None:
        return None
    recs, window = got
    if not all(hasattr(r, "timed_ms") for r in window):
        return None
    total = 0.0
    for r in window:
        if _root(recs, r).name not in ROOTS:
            continue
        ms = r.timed_ms(SITE)
        if ms is None:
            return None
        total += ms
    return total / _queries(window)
