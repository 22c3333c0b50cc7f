"""Entries into the program, one module a way in, named by a traffic
mix's ``entry`` key.  Each module has

- ``prepare(ctx, cols) -> state``: the program's objects for one data
  instance (``ctx``: the harness's :class:`~bench_cuda.harness.Context`);
- ``query(state, mark) -> out``: one whole query through the program's
  own calls, ``mark(phase)`` before each phase and ``mark(None)`` after
  the last;
- ``counters(out) -> dict``: the program's counters (device scalars) under
  the reference's names, plus ``overflow`` where the path has one;
- ``route(out) -> int``: the worst windowed-lookup route (0 windowed);
- ``rows(out) -> dict``: the result rows the reference judges.
"""
