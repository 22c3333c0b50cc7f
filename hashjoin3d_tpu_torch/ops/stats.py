"""Hash-table statistics: the ht_* columns of the exp-1 CSV.

Port of ``hashjoin3d_tpu/ops/stats.py:chaining_statistics`` (reference
``HtChaining1::makeStatistics``, ``ht_chaining.hh:260-292``).  Computed in
numpy from ``bucket_len`` after the measurement, as the reference computes
them after its loop.  A chain's length counts its directory node, so
non-empty buckets have length >= 1; cc0 aggregates all buckets, cc1 only the
non-empty ones.
"""

from __future__ import annotations

import numpy as np

from .chaining import ChainingTable


def _agg(a: np.ndarray):
    """(avg, min, max) like the reference's Aggregate (empty: nan, max
    int64, 0)."""
    if a.size == 0:
        return float("nan"), (1 << 63) - 1, 0
    return (float(a.sum(dtype=np.int64)) / a.size, int(a.min()),
            int(a.max()))


def chaining_statistics(table: ChainingTable) -> list:
    """The eight ht_* CSV fields: ht_buckets, ht_fracEmpty, cc0_avg,
    cc0_min, cc0_max, cc1_avg, cc1_min, cc1_max
    (``main_experiment1.cc:719-726``)."""
    blen = table.bucket_len.cpu().numpy()
    cc0 = _agg(blen)
    cc1 = _agg(blen[blen > 0])
    return [int(blen.size), int((blen == 0).sum()) / blen.size, *cc0, *cc1]
