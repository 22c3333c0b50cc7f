"""The plain references, one module a join shape, named by a traffic mix's
``reference`` key.  Plain ``torch`` on whatever device holds the columns;
nothing of the program is imported or read.  Each module has

- ``expect(cols, config, traffic) -> dict``: the exact counters and result
  size of the join the traffic runs;
- ``judge(cols, kept, expected) -> dict``: the numbers compared for one
  query's output (``kept``: its result rows and counters);
- ``control(cols, config, traffic, expected) -> dict``: the same numbers
  for the reference itself computed on keys of the next lower width
  (u16 for the configurations' u32 keys), which has to fail them.

Every number is exact and held to the limit 0 (``LIMITS``).
"""
