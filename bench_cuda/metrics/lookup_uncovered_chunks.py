"""Chunks a query whose keys the windowed lookups' windows left uncovered:
the program's ``lookup.uncovered`` tally (``tracing.count`` in
``safe_lookup``), summed over the records under the ``hj.build`` and
``hj.probe`` roots of the traced window.  0 where every lookup kept its
windows; None without a trace, a probe root, or on a program that keeps
no tallies."""

from ..program_trace import _queries, _root, _window

ROOTS = ("hj.build", "hj.probe")


def read(run):
    got = _window(run)
    if got is None:
        return None
    recs, window = got
    if not all(hasattr(r, "counts") for r in window):
        return None
    n = sum(r.counts.get("lookup.uncovered", 0) for r in window
            if _root(recs, r).name in ROOTS)
    return n / _queries(window)
