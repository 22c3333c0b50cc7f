"""The port's auxiliary operators on the CPU against the JAX package:
``apply_predicate``, ``compact``, ``sort_by_key``, ``sort_rows``,
``radix_partition``, ``hash_aggregate`` and the per-bucket statistics.

Same seeded numpy inputs on both sides, the cases of
``tests/test_ops_misc.py`` and wider ones (u32 keys at and above 2^31, u64
keys, masks).  Integer results are exact; ``hash_aggregate``'s float64
sums of a float column agree to a relative 1e-12 of the column's absolute
sum (both sides take a prefix-sum difference, summed in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hashjoin3d_tpu.ops import stats as jstats
from hashjoin3d_tpu.ops.aggregate import hash_aggregate as jax_aggregate
from hashjoin3d_tpu.ops.chaining import build_chaining as jax_chaining
from hashjoin3d_tpu.ops.filter import apply_predicate as jax_predicate
from hashjoin3d_tpu.ops.filter import compact as jax_compact
from hashjoin3d_tpu.ops.nested import build_nested as jax_nested
from hashjoin3d_tpu.ops.sort import radix_partition as jax_partition
from hashjoin3d_tpu.ops.sort import sort_by_key as jax_sort_by_key
from hashjoin3d_tpu.ops.sort import sort_rows as jax_sort_rows

from hashjoin3d_tpu_torch.ops import stats as tstats
from hashjoin3d_tpu_torch.ops.aggregate import hash_aggregate
from hashjoin3d_tpu_torch.ops.chaining import build_chaining
from hashjoin3d_tpu_torch.ops.filter import apply_predicate, compact
from hashjoin3d_tpu_torch.ops.layout import key_column
from hashjoin3d_tpu_torch.ops.nested import build_nested
from hashjoin3d_tpu_torch.ops.sort import (radix_partition, sort_by_key,
                                           sort_rows)

FLOAT_RTOL = 1e-12


def t(a):
    """A numpy column as the port's tensor: unsigned as its carrier."""
    a = np.asarray(a)
    return key_column(a, "cpu") if a.dtype.kind == "u" else \
        torch.from_numpy(a.copy())


def same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    if want.dtype.kind == "u":
        want = want.view(np.int32 if want.dtype.itemsize == 4 else np.int64)
    return (tuple(got.shape) == want.shape
            and np.array_equal(got.numpy(), want))


def test_filter_and_compact_match_jax():
    cols = {"a": np.arange(10, dtype=np.uint32),
            "b": np.arange(10, dtype=np.int32) * 10}
    jcols = {k: jnp.asarray(v) for k, v in cols.items()}
    tcols = {k: t(v) for k, v in cols.items()}
    jmask = jax_predicate(lambda c: c["b"] < 45, jcols)
    mask = apply_predicate(lambda c: c["b"] < 45, tcols)
    assert same(mask, jmask)
    for out_size in (8, 3):
        jp, jrows, jcount = jax_compact(jmask, jcols, out_size)
        packed, rows, count = compact(mask, tcols, out_size)
        assert int(count) == int(jcount) == 5
        assert same(rows, jrows)
        for k in cols:
            assert same(packed[k], jp[k]), k
    # with an input mask, over 2^12 rows with u32 values >= 2^31
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    m = rng.random(4096) < 0.5
    jm = jax_predicate(lambda c: c["a"] >= 2**31, {"a": jnp.asarray(a)},
                       jnp.asarray(m))
    tm = apply_predicate(lambda c: c["a"] < 0, {"a": t(a)}, t(m))
    assert same(tm, jm)
    jp, jrows, jcount = jax_compact(jm, {"a": jnp.asarray(a)}, 2048)
    packed, rows, count = compact(tm, {"a": t(a)}, 2048)
    assert int(count) == int(jcount)
    assert same(rows, jrows) and same(packed["a"], jp["a"])


@pytest.mark.parametrize("kind", ["u30", "u32", "u64", "i32", "f32"])
def test_sorts_match_jax(kind):
    rng = np.random.default_rng(2)
    if kind == "u30":  # the case of tests/test_ops_misc.py
        keys = rng.integers(0, 1 << 30, 1000, dtype=np.uint32)
    elif kind == "u32":
        keys = rng.integers(0, 2**32, 1000, dtype=np.uint32)
        keys[::7] = keys[3]
    elif kind == "u64":
        keys = rng.integers(0, 2**64 - 1, 1000, dtype=np.uint64)
        keys[::5] = keys[1]
    elif kind == "i32":
        keys = rng.integers(-500, 500, 1000).astype(np.int32)
    else:
        keys = rng.standard_normal(1000).astype(np.float32)
    pay = rng.integers(0, 100, 1000, dtype=np.int32)
    unsigned = kind.startswith("u")
    jk, jp = jax_sort_by_key(jnp.asarray(keys), jnp.asarray(pay))
    sk, sp = sort_by_key(t(keys), t(pay), unsigned=unsigned)
    assert same(sk, jk) and same(sp, jp)
    jk, jrows = jax_sort_rows(jnp.asarray(keys))
    sk, rows = sort_rows(t(keys), unsigned=unsigned)
    assert same(sk, jk) and same(rows, jrows)
    assert same(rows, np.argsort(keys, kind="stable").astype(np.int32))


@pytest.mark.parametrize("by_hash", [True, False])
@pytest.mark.parametrize("kind", ["small", "wide", "masked"])
def test_radix_partition_matches_jax(kind, by_hash):
    rng = np.random.default_rng(3)
    hi = 1000 if kind == "small" else 2**32
    keys = rng.integers(0, hi, 800, dtype=np.uint32)
    rows = np.arange(800, dtype=np.int32)
    valid = rng.random(800) < 0.7 if kind == "masked" else None
    want = jax_partition(jnp.asarray(keys), 16, jnp.asarray(rows),
                         by_hash=by_hash,
                         valid=None if valid is None else jnp.asarray(valid))
    got = radix_partition(t(keys), 16, t(rows), by_hash=by_hash,
                          valid=None if valid is None else t(valid))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert same(g, w)
    # payload consistency: the key at each row id
    assert same(got[1], keys[got[2].numpy()])


def _aggregate_case(case: str):
    """(keys, values, mask, n_keys hint) of each case."""
    rng = np.random.default_rng(77)
    n = 500
    if case == "numpy":  # tests/test_ops_misc.py's first case
        rng = np.random.default_rng(1)
        return (rng.integers(0, 30, n, dtype=np.uint32),
                {"v": rng.integers(0, 1000, n, dtype=np.int32)}, None, None)
    keys = rng.integers(0, 50, n, dtype=np.uint32)
    vals = {"v": rng.integers(-100, 100, n, dtype=np.int32)}
    if case == "hint":
        return keys, vals, None, int(np.unique(keys).size)
    if case == "short_hint":
        return keys, vals, None, 20
    if case == "masked":
        return keys, vals, rng.random(n) < 0.6, None
    if case == "wide":
        keys = rng.integers(2**31 - 20, 2**31 + 20, n).astype(np.uint32)
        keys[::9] = 2**32 - 1
        return keys, {"v": vals["v"], "w": rng.integers(
            -2**40, 2**40, n, dtype=np.int64)}, rng.random(n) < 0.8, None
    if case == "u64":
        keys = (keys.astype(np.uint64) << np.uint64(33)) | np.uint64(7)
        return keys, vals, rng.random(n) < 0.8, 64
    if case == "float":
        return keys, {"f": (rng.standard_normal(n) * 1e3).astype(np.float32),
                      "d": rng.standard_normal(n)}, rng.random(n) < 0.9, None
    if case == "count_only":
        return keys, {}, rng.random(n) < 0.5, None
    assert case == "empty"
    return np.zeros(0, np.uint32), {"v": np.zeros(0, np.int32)}, None, 1


@pytest.mark.parametrize("case", ["numpy", "hint", "short_hint", "masked",
                                  "wide", "u64", "float", "count_only",
                                  "empty"])
def test_hash_aggregate_matches_jax(case):
    keys, vals, mask, hint = _aggregate_case(case)
    want = jax_aggregate(jnp.asarray(keys),
                         {k: jnp.asarray(v) for k, v in vals.items()},
                         mask=None if mask is None else jnp.asarray(mask),
                         n_keys=hint)
    got = hash_aggregate(t(keys), {k: t(v) for k, v in vals.items()},
                         mask=None if mask is None else t(mask), n_keys=hint)
    for f in ("ukey", "group_start", "group_len", "n_keys"):
        assert same(getattr(got.groups, f), getattr(want.groups, f)), f
    assert same(got.count, want.count)
    assert same(got.keys, want.keys) and int(got.n_keys) == int(want.n_keys)
    for name, col in vals.items():
        assert same(got.mins[name], want.mins[name]), name
        assert same(got.maxs[name], want.maxs[name]), name
        gs, ws = got.sums[name].numpy(), np.asarray(want.sums[name])
        assert gs.dtype == ws.dtype
        if col.dtype.kind == "f":
            assert gs.dtype == np.float64
            tol = FLOAT_RTOL * max(float(np.abs(col).astype(np.float64)
                                         .sum()), 1.0)
            assert np.abs(gs - ws).max(initial=0.0) <= tol, name
        else:
            assert gs.dtype == np.int64 and np.array_equal(gs, ws), name
    # and against numpy, group by group
    nk = int(got.n_keys)
    live = np.ones(keys.size, bool) if mask is None else mask
    uk = np.unique(keys[live])[:nk]
    ukey = got.keys.numpy()[:nk].view(keys.dtype)
    assert np.array_equal(ukey, uk)
    for g, k in enumerate(uk):
        sel = live & (keys == k)
        assert int(got.count[g]) == sel.sum()
        for name, col in vals.items():
            if col.dtype.kind != "f":
                assert int(got.sums[name][g]) == int(col[sel].astype(
                    object).sum())
                assert int(got.mins[name][g]) == col[sel].min()
                assert int(got.maxs[name][g]) == col[sel].max()


def test_bucket_statistics_match_jax():
    """tests/test_ops_misc.py's case, and a wider one under murmur and
    identity (the nested dump buckets its rows by murmur32 either way)."""
    rng = np.random.default_rng(4)
    cases = [(np.array([1, 1, 2, 5], np.uint32), 4, "murmur"),
             (rng.integers(0, 300, 2000, dtype=np.uint32), 61, "murmur"),
             (rng.integers(0, 300, 2000, dtype=np.uint32), 61, "identity")]
    for keys, nb, hf in cases:
        jc = jax_chaining(jnp.asarray(keys), nb, hashfun=hf)
        tc = build_chaining(t(keys), nb, hashfun=hf)
        jrows = jstats.bucket_statistics_chaining(jc)
        rows = tstats.bucket_statistics_chaining(tc)
        assert [r.to_csv_string() for r in rows] == \
            [r.to_csv_string() for r in jrows]
        jn = jax_nested(jnp.asarray(keys), nb, hashfun=hf)
        tn = build_nested(t(keys), nb, hashfun=hf)
        jrows = jstats.bucket_statistics_nested(jn)
        rows = tstats.bucket_statistics_nested(tn)
        assert [r.to_csv_string() for r in rows] == \
            [r.to_csv_string() for r in jrows]
        assert sum(r.num_entries for r in rows) == keys.size
        assert sum(r.chain_len for r in rows) == np.unique(keys).size
        assert tstats.HtBucketStatistics.CSV_HEADER == \
            jstats.HtBucketStatistics.CSV_HEADER
