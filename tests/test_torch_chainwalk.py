"""The one-pass bucket hashes (``ops/chainwalk.py``) on the CPU, through
their wrappers (the plain versions).

The chain-length sum is held against the composition it replaced: hash,
``bucket_of``, a ``where`` that marks the non-walking probes -1, the sort of
the bucket ids and a gather of the lengths with miss-as-0, summed.  The
builds' bucket ids are held against ``bucket_of(hash_key(...))`` and its
``where``, and the nested build's main chains against the code that
computed them that way.  Those compositions are kept here as the oracles,
in torch primitives.  The CUDA kernels themselves need the card:
``chip_smoke.py`` holds them against the plain versions there.
"""

import functools
import types

import numpy as np
import pytest
import torch

from hashjoin3d_tpu_torch.ops import chaining, nested
from hashjoin3d_tpu_torch.ops import strands_windowed as sw
from hashjoin3d_tpu_torch.ops.chainwalk import (bucket_ids, miss_chain_sum,
                                                miss_chain_sum_plain)
from hashjoin3d_tpu_torch.ops.hashing import bucket_of, hash_key
from hashjoin3d_tpu_torch.ops.layout import (I32, I64, compact_group_index,
                                             group_capacity, sort_with_rows)
from hashjoin3d_tpu_torch.ops.runs import run_histogram_plain

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


# -- the builds' bucket ids ---------------------------------------------------

N_IDS = 2999  # no multiple of the kernel's 4 keys a step


@pytest.mark.parametrize("hashfun", ["murmur", "identity", "fib", xor_fold],
                         ids=["murmur", "identity", "fib", "callable"])
@pytest.mark.parametrize("wide", [False, True], ids=["u32", "u64"])
def test_bucket_ids_equal_the_composition(wide, hashfun):
    """``where(live, bucket_of(hash_key(k, f), nb), nb)`` as int32, shaped
    like the keys, on the carriers' edge keys, with no live mask, every key
    dead and a random mask.  On the CPU the wrapper is its plain twin, so
    this checks the dispatch and the dtype; ``chip_smoke.py`` holds the
    kernel to the plain twin bit for bit on the card."""
    keys = probe_keys(wide, 3 if wide else 0)[:N_IDS]
    for live in (None, torch.zeros(N_IDS, dtype=torch.bool),
                 walk_mask("random", 5)[:N_IDS]):
        for num_buckets in (1, 7, 5_242_880, 2**31 - 1):
            b = bucket_of(hash_key(keys, hashfun), num_buckets)
            want = b if live is None else torch.where(live, b, num_buckets)
            got = bucket_ids(keys, num_buckets, hashfun, live)
            assert got.dtype == I32 and got.shape == keys.shape
            assert torch.equal(got, want)


def ndu_directory(wide: bool, seed: int):
    """A small exp-4 Ndu S build's directory: 64 common keys 4 times and
    256 own keys twice, shuffled, compacted into a power-of-two capacity
    with padding groups."""
    rng = np.random.default_rng(seed)
    common = rng.choice(2**32, 64 + 256, replace=False).astype(np.uint64)
    k = np.concatenate([np.repeat(common[:64], 4), np.repeat(common[64:], 2)])
    k = rng.permutation(k)
    if wide:
        keys = torch.from_numpy((k * np.uint64(0x9E3779B97F4A7C15))
                                .view(np.int64))
    else:
        keys = torch.from_numpy(k.astype(np.uint32).view(np.int32))
    skey, srow, nk = sort_with_rows(keys)
    cap = group_capacity(int(nk), keys.shape[0])
    assert cap > int(nk)  # padding groups take part
    return compact_group_index(keys, skey, srow, cap)


def old_main_chains(groups, num_buckets, hashfun):
    """``_main_chains`` with its bucket hash as the int64 composition."""
    validg = groups.group_len > 0
    b_main = torch.where(validg, bucket_of(hash_key(groups.ukey, hashfun),
                                           num_buckets), num_buckets)
    packed = (b_main.to(I64) << 32) | groups.first_row.to(I64)
    pk_s, gid_s = torch.sort(packed, stable=True)
    bucket_main_len, main_pos = run_histogram_plain(
        (pk_s >> 32).to(I32), gid_s, num_buckets)
    return main_pos, bucket_main_len


@pytest.mark.parametrize("wide", [False, True], ids=["u32", "u64"])
def test_ndu_shaped_main_chains_equal_the_old_hash(wide):
    groups = ndu_directory(wide, 21 + wide)
    nb = 5 * groups.ukey.shape[0] // 8  # Ndu's buckets over its capacity
    got = nested._main_chains(groups, nb, "murmur")
    want = old_main_chains(groups, nb, "murmur")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _perm_keys(n=1024, seed=4):
    return torch.from_numpy(np.random.default_rng(seed).permutation(n)
                            .astype(np.int32))


def _dup_keys(n=1024, seed=5):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, n // 8, n).astype(np.int32))


#: build -> (call, bucket_ids calls it makes): every hash site of the
#: build strand
BUILD_HASH_SITES = {
    "nested compacted": (lambda: nested._build_nested_fused(
        _dup_keys(), 128, 97, False), 1),
    "nested dense-direct": (lambda: nested._build_nested_dense(
        _perm_keys(), 97), 1),
    "nested clarity": (lambda: nested.build_nested(
        _dup_keys(), 97, valid=_dup_keys() % 3 > 0), 1),
    "chaining dense-direct": (lambda: chaining._build_chaining_dense(
        _perm_keys(), 97), 1),
    "chaining dense-direct, chain_by_key": (
        lambda: chaining._build_chaining_dense(_perm_keys(), 97,
                                               full_chain_index=True), 2),
    "chaining clarity": (lambda: chaining.build_chaining(
        _dup_keys(), 97, valid=_dup_keys() % 3 > 0), 1),
    "chaining compacted, group branch": (
        lambda: chaining._build_chaining_fused(
            _dup_keys(), 128, 97, False, early_exit_index=False), 1),
    "chaining compacted, row branch": (
        lambda: chaining._build_chaining_fused(_dup_keys(), 128, 97, False),
        1),
}


@pytest.mark.parametrize("site", BUILD_HASH_SITES)
def test_every_build_hash_goes_through_bucket_ids(site, monkeypatch):
    calls = []
    for module in (nested, chaining):
        monkeypatch.setattr(
            module, "bucket_ids",
            lambda *a, **k: calls.append(1) or bucket_ids(*a, **k))
    build, want = BUILD_HASH_SITES[site]
    build()
    assert len(calls) == want


@pytest.mark.parametrize("bad,match", [
    (dict(keys=torch.zeros(4, dtype=torch.int16)), "keys"),
    (dict(keys=torch.zeros((2, 2), dtype=I32)), "keys"),
    (dict(live=torch.zeros(4, dtype=I32)), "live"),
    (dict(live=torch.zeros(5, dtype=torch.bool)), "live"),
    (dict(num_buckets=0), "num_buckets"),
    (dict(num_buckets=1 << 31), "num_buckets"),
    (dict(num_buckets=2**31 + 11, live=None), "num_buckets"),
])
def test_bucket_ids_rejects_what_the_kernel_does_not_take(bad, match):
    args = dict(keys=torch.zeros(4, dtype=I32), num_buckets=4,
                live=torch.zeros(4, dtype=torch.bool))
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        bucket_ids(**args)
