"""Hash-table statistics: the ht_* columns of the exp-1 CSV.

Port of ``hashjoin3d_tpu/ops/stats.py`` (``HtStatistics``,
``chaining_statistics``, ``nested_statistics``; reference
``ht_statistics.{hh,cc}``, ``ht_chaining.hh:260-292``,
``ht_nested.hh:450-482``).  Computed after the measurement from the
table's bucket histogram, as the reference computes them after its loop.
A chain's length counts its directory node, so non-empty buckets have
length >= 1; cc0 aggregates all buckets, cc1 only the non-empty ones.  The
chaining table counts distinct *hash values* as its distinct keys (its
node stores no key accessor, ``ht_chaining.hh:282-283``); the nested
table counts MainNodes (distinct keys) per bucket.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.aggregate import Aggregate
from .chaining import ChainingTable
from .hashing import murmur32
from .nested import NestedTable


@dataclass
class HtStatistics:
    num_buckets: int = 0
    num_empty_buckets: int = 0
    num_entries: int = 0
    num_distinct_keys: int = 0
    collision_chain_len: Aggregate = field(default_factory=Aggregate)
    collision_chain_len_nonempty: Aggregate = field(default_factory=Aggregate)

    def frac_empty_buckets(self) -> float:
        return self.num_empty_buckets / self.num_buckets

    def to_csv_fields(self) -> list:
        """The eight ht_* CSV fields: ht_buckets, ht_fracEmpty, cc0_avg,
        cc0_min, cc0_max, cc1_avg, cc1_min, cc1_max
        (``main_experiment1.cc:719-726``)."""
        cc0, cc1 = self.collision_chain_len, self.collision_chain_len_nonempty
        return [
            self.num_buckets,
            self.frac_empty_buckets(),
            float(cc0.avg()),
            cc0.min(),
            cc0.max(),
            float(cc1.avg()),
            cc1.min(),
            cc1.max(),
        ]


def _from_chain_lens(chain_lens: np.ndarray, num_entries: int,
                     num_distinct: int) -> HtStatistics:
    s = HtStatistics()
    s.num_buckets = int(chain_lens.size)
    s.num_empty_buckets = int((chain_lens == 0).sum())
    s.num_entries = int(num_entries)
    s.num_distinct_keys = int(num_distinct)
    s.collision_chain_len = Aggregate.from_array(chain_lens)
    s.collision_chain_len_nonempty = Aggregate.from_array(
        chain_lens[chain_lens > 0])
    return s


def chaining_statistics(table: ChainingTable) -> HtStatistics:
    """``HtChaining1::makeStatistics`` equivalent."""
    blen = table.bucket_len.cpu().numpy()
    ndistinct_hash = torch.unique(murmur32(table.keys)).numel()
    return _from_chain_lens(blen, table.keys.shape[0], ndistinct_hash)


def nested_statistics(table: NestedTable) -> HtStatistics:
    """``HtNested1::makeStatistics`` equivalent: chain lengths count
    MainNodes (distinct keys) per bucket; SubNodes are not chain
    entries."""
    bml = table.bucket_main_len.cpu().numpy()
    return _from_chain_lens(bml, table.keys.shape[0],
                            int(table.groups.n_keys))
