"""min/max/sum/count aggregate, mirroring ``util/aggregate.hh:12-103``.

Port of ``hashjoin3d_tpu/utils/aggregate.py``.  The hash-table statistics
(``ops/stats.py``) fold the collision-chain lengths over all and over the
non-empty buckets with it, exactly as the reference does:
``Aggregate.from_array`` folds a whole numpy column at once.  An empty
column keeps the reference's initial values (min the largest int64, max 0,
avg nan).
"""

from __future__ import annotations

import numpy as np

_INT_MAX = (1 << 63) - 1


class Aggregate:
    """min/max/sum/count of a column, with its average (the part of the
    reference's Aggregate the hash-table statistics read)."""

    def __init__(self):
        self._min = _INT_MAX
        self._max = 0
        self._sum = 0
        self._count = 0

    @classmethod
    def from_array(cls, a: np.ndarray) -> "Aggregate":
        agg = cls()
        if a.size:
            agg._min = int(a.min())
            agg._max = int(a.max())
            agg._sum = int(a.sum(dtype=np.int64))
            agg._count = int(a.size)
        return agg

    def count(self):
        return self._count

    def min(self):
        return self._min

    def max(self):
        return self._max

    def sum(self):
        return self._sum

    def avg(self) -> float:
        return self._sum / self._count if self._count else float("nan")

    def __repr__(self):
        return (f"Aggregate(min={self._min}, max={self._max}, "
                f"avg={self.avg():.6g}, count={self._count})")
