"""The one-pass chain-length sum (``ops/chainwalk.py``) on the CPU, through
its wrapper (the plain version), against the composition it replaced: hash,
``bucket_of``, a ``where`` that marks the non-walking probes -1, the sort of
the bucket ids and a gather of the lengths with miss-as-0, summed.  That
composition is kept here as the oracle, in torch primitives.  The CUDA
kernel itself needs the card: ``chip_smoke.py`` holds it against the plain
version there.
"""

import functools
import types

import numpy as np
import pytest
import torch

from hashjoin3d_tpu_torch.ops import strands_windowed as sw
from hashjoin3d_tpu_torch.ops.chainwalk import (miss_chain_sum,
                                                miss_chain_sum_plain)
from hashjoin3d_tpu_torch.ops.hashing import bucket_of, hash_key
from hashjoin3d_tpu_torch.ops.layout import I32, I64

N = 3000  # no multiple of the old lookup's chunk


def old_miss_walk(bucket_len, num_buckets, keys, mask, hashfun):
    """The chain walk before the one-pass sum: the sorted bucket ids (-1
    where a probe does not walk), their lengths gathered (a bucket outside
    the table reads 0), summed."""
    b = bucket_of(hash_key(keys, hashfun), num_buckets).long()
    b_sorted = torch.sort(torch.where(mask, b, -1)).values
    T = bucket_len.shape[0]
    inside = (b_sorted >= 0) & (b_sorted < T)
    walked = bucket_len[b_sorted.clamp(0, T - 1)]
    return torch.where(inside, walked, 0).to(I64).sum()


def xor_fold(x):
    """A callable functor: carrier in, same-width carrier out."""
    return x ^ (x >> 7) ^ 0x5A5A


@functools.lru_cache(maxsize=None)
def lengths(T: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(T).integers(
        0, 40, T).astype(np.int32))


def probe_keys(wide: bool, seed: int) -> torch.Tensor:
    """Seeded keys with the carriers' edges: 0, 2^31, 2^32 - 1 (u64: also
    2^64 - 1 and 2^63)."""
    rng = np.random.default_rng(seed)
    if wide:
        k = rng.integers(0, 2**64, N, dtype=np.uint64)
        k[:5] = [0, 2**31, 2**32 - 1, 2**64 - 1, 2**63]
        return torch.from_numpy(k.view(np.int64))
    k = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    k[:3] = [0, 2**31, 2**32 - 1]
    return torch.from_numpy(k.view(np.int32))


def walk_mask(kind: str, seed: int) -> torch.Tensor:
    if kind == "none":
        return torch.zeros(N, dtype=torch.bool)
    if kind == "all":
        return torch.ones(N, dtype=torch.bool)
    m = torch.from_numpy(np.random.default_rng(seed + 1).random(N) < 0.6)
    m[:5] = True  # the edge keys walk
    return m


@pytest.mark.parametrize("num_buckets", [1, 7, 5_242_880])
@pytest.mark.parametrize("mask_kind", ["none", "all", "random"])
@pytest.mark.parametrize("hashfun", ["murmur", "identity", "fib", xor_fold],
                         ids=["murmur", "identity", "fib", "callable"])
@pytest.mark.parametrize("wide", [False, True], ids=["u32", "u64"])
def test_miss_chain_sum_equals_the_sorted_walk(wide, hashfun, mask_kind,
                                               num_buckets):
    seed = num_buckets + (3 if wide else 0)
    keys, mask = probe_keys(wide, seed), walk_mask(mask_kind, seed)
    bl = lengths(num_buckets)
    want = int(old_miss_walk(bl, num_buckets, keys, mask, hashfun))
    got = miss_chain_sum(keys, mask, bl, num_buckets, hashfun)
    assert got.dtype == I64 and got.dim() == 0
    assert int(got) == want
    # the strands' call sites: the miss walk (guard included) and the
    # whole-chain walk over the live probes
    assert int(sw._miss_chain_cmps(bl, num_buckets, keys, mask,
                                   hashfun)) == want
    table = types.SimpleNamespace(bucket_len=bl, num_buckets=num_buckets,
                                  hashfun=hashfun)
    assert int(sw._full_chain_cmps(table, keys, mask)) == want
    if mask_kind == "all":  # the oracle's walk is not empty
        assert want > 0


@pytest.mark.parametrize("T", [5, 100])
def test_a_bucket_past_the_table_reads_zero(T):
    """A table shorter than ``num_buckets``: the buckets past it add 0, as
    the windowed lookup's miss-as-0 gave."""
    keys, mask = probe_keys(False, 9), walk_mask("random", 9)
    bl = lengths(T)
    want = int(old_miss_walk(bl, 100, keys, mask, "murmur"))
    assert int(miss_chain_sum_plain(keys, mask, bl, 100)) == want
    assert int(miss_chain_sum(keys, mask, bl, 100)) == want


@pytest.mark.parametrize("bad,match", [
    (dict(keys=torch.zeros(4, dtype=torch.int16)), "keys"),
    (dict(mask=torch.zeros(4, dtype=torch.int32)), "mask"),
    (dict(mask=torch.zeros(5, dtype=torch.bool)), "mask"),
    (dict(bucket_len=torch.zeros(4, dtype=I64)), "bucket_len"),
    (dict(num_buckets=0), "num_buckets"),
    (dict(num_buckets=1 << 31), "num_buckets"),
])
def test_miss_chain_sum_rejects_what_the_kernel_does_not_take(bad, match):
    args = dict(keys=torch.zeros(4, dtype=I32),
                mask=torch.zeros(4, dtype=torch.bool),
                bucket_len=torch.zeros(4, dtype=I32), num_buckets=4)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        miss_chain_sum(**args)
