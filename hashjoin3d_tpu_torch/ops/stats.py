"""Hash-table statistics: the ht_* columns of the exp-1 CSV.

Port of ``hashjoin3d_tpu/ops/stats.py`` (``HtStatistics``,
``chaining_statistics``, ``nested_statistics``, ``HtBucketStatistics``,
``bucket_statistics_chaining``, ``bucket_statistics_nested`` and the host
engine's twins ``chaining_statistics_np`` / ``nested_statistics_np``; reference
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
from .hashing import murmur32, murmur32_np
from .layout import u32_to_i64
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


@dataclass
class HtBucketStatistics:
    """One bucket's row of the per-bucket dump (``ht_statistics.hh:9-15``)."""

    bucket_index: int
    num_entries: int
    chain_len: int

    CSV_HEADER = "bucketIndex;numEntries;chainLen"

    def to_csv_string(self) -> str:
        return f"{self.bucket_index};{self.num_entries};{self.chain_len}"


def bucket_statistics_chaining(table: ChainingTable) -> list:
    """Per-bucket dump of a chaining table: a chain's length is its
    entries."""
    blen = table.bucket_len.cpu().numpy()
    return [HtBucketStatistics(i, int(v), int(v)) for i, v in enumerate(blen)]


def bucket_statistics_nested(table: NestedTable) -> list:
    """Per-bucket dump of a 3D table: the chain length counts MainNodes,
    the entries count rows.  The rows are bucketed by ``murmur32`` of the
    key whatever the table's ``hashfun``, as the JAX package does."""
    bml = table.bucket_main_len.cpu().numpy()
    b = (u32_to_i64(murmur32(table.keys)) % table.num_buckets).cpu().numpy()
    rows = np.bincount(b, minlength=table.num_buckets)
    return [HtBucketStatistics(i, int(rows[i]), int(bml[i]))
            for i in range(table.num_buckets)]


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


def chaining_statistics_np(build_keys, num_buckets: int) -> HtStatistics:
    """:func:`chaining_statistics` from the raw build keys, for the host
    engine's plans, where no device table exists (u32 keys, murmur, as
    the JAX package's twin)."""
    bk = np.asarray(build_keys, np.uint32)
    h = murmur32_np(bk)
    blen = np.bincount(h % np.uint32(num_buckets), minlength=num_buckets)
    return _from_chain_lens(blen, bk.size, np.unique(h).size)


def nested_statistics_np(build_keys, num_buckets: int) -> HtStatistics:
    """:func:`nested_statistics` from the raw build keys (host engine)."""
    bk = np.asarray(build_keys, np.uint32)
    uk = np.unique(bk)
    bml = np.bincount(murmur32_np(uk) % np.uint32(num_buckets),
                      minlength=num_buckets)
    return _from_chain_lens(bml, bk.size, uk.size)
