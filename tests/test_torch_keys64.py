"""The port's 64-bit keys on the CPU against the JAX package: every hash
functor in both widths, ``bucket_of`` on 64-bit hashes, the carriers, and
the compacted builds on u64 keys.

Same seeded numpy inputs on both sides, exact equality (integer work: the
tolerance is zero; Fibonacci hashing is float64 on both sides and its
integer results are compared bit for bit):

* murmur, boncz, fib, mult and identity, u32 and u64, against the JAX
  registry and the port's own numpy mirrors, at 0, 1, 2^31, 2^32 - 1,
  2^63 - 1, 2^63, 2^64 - 1 and random values; a callable functor;
* the u64 -> f64 conversion, rounded once, where converting the signed
  carrier would round twice; f64 -> u64 at 2^64 as the JAX package casts;
* ``bucket_of`` at ``nb`` 1, 3, 2^20 and 2^31 - 1;
* ``pack2u32``, ``canon_key_dtype`` and the host-column carrier on int8,
  u16, i32 and i64 inputs, and the u32 -> u64 zero extension;
* the compacted nested and chaining builds (early-exit index on and off)
  on t=4-like and zipf-like u64 keys, keys on two hi planes and a key of
  2^64 - 1, field by field, and ``convert.py`` for those tables.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashjoin3d_tpu.ops import hashing as jh
from hashjoin3d_tpu.ops import layout as jl
from hashjoin3d_tpu.ops.chaining import build_chaining_host as jax_chaining
from hashjoin3d_tpu.ops.nested import build_nested_host as jax_nested

from hashjoin3d_tpu_torch.convert import (CHAINING_FIELDS, NESTED_FIELDS,
                                          OPTIONAL_FIELDS,
                                          chaining_table_from_numpy,
                                          nested_table_from_numpy)
from hashjoin3d_tpu_torch.ops import hashing as th
from hashjoin3d_tpu_torch.ops import layout as tl
from hashjoin3d_tpu_torch.ops.chaining import build_chaining_host
from hashjoin3d_tpu_torch.ops.nested import build_nested_host

EDGES64 = np.array([0, 1, 2**31, 2**32 - 1, 2**63 - 1, 2**63, 2**64 - 1,
                    2**63 + 2**10 + 1, 2**53 + 1], np.uint64)
FUNCTORS = ("murmur", "boncz", "fib", "mult", "identity")
N = 1 << 13


def values(wide: bool) -> np.ndarray:
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 2**64 - 1, 4096, dtype=np.uint64)
    x = np.concatenate([EDGES64, rand])
    return x if wide else x.astype(np.uint32)


def carrier(a):
    return tl.key_column(a, "cpu")


def unsigned(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64 if t.dtype == torch.int64 else np.uint32)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("name", FUNCTORS)
def test_functor_matches_jax_and_numpy(name, wide):
    x = values(wide)
    want = np.asarray(jh.HASH_FUNCTORS[name][int(wide)](jnp.asarray(x)))
    got = th.hash_key(carrier(x), name)
    assert got.dtype == (torch.int64 if wide else torch.int32)
    assert np.array_equal(unsigned(got), want)
    assert np.array_equal(th.hash_key_np(x, name), want)
    assert np.array_equal(th.hash_key_np(x, name),
                          jh.hash_key_np(x, name))


def test_callable_functor_both_widths():
    for wide in (False, True):
        x = values(wide)
        got = th.hash_key(carrier(x), lambda k: k * 3 + 1)
        with np.errstate(over="ignore"):
            want = x * x.dtype.type(3) + x.dtype.type(1)
        assert np.array_equal(unsigned(got), want)
        assert np.array_equal(th.hash_key_np(x, lambda k: k * 3 + 1), want)


def test_u64_to_f64_rounds_once():
    x = values(True)
    got = th.u64_to_f64(carrier(x)).numpy()
    assert np.array_equal(got, x.astype(np.float64))
    # the signed carrier of 2^63 + 2^10 + 1 rounds twice through -2^63
    twice = carrier(EDGES64[7:8]).to(torch.float64) + 2.0**64
    assert twice.item() != got[7]


def test_f64_to_u64_saturates_at_2_64_as_jax():
    r = np.array([0.0, 2.0**52, 2.0**63, 2.0**64 - 2048, 2.0**64])
    want = np.asarray(jnp.asarray(r).astype(jnp.uint64))
    assert np.array_equal(unsigned(th.f64_to_u64(torch.from_numpy(r))), want)
    assert want[-1] == 2**64 - 1


@pytest.mark.parametrize("nb", [1, 3, 1 << 20, 2**31 - 1])
def test_bucket_of_u64_matches_jax(nb):
    h = values(True)
    want = np.asarray(jh.bucket_of(jnp.asarray(h), nb))
    got = th.bucket_of(carrier(h), nb)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_pack2u32_matches_jax():
    rng = np.random.default_rng(1)
    hi = rng.integers(0, 2**32, 512, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, 512, dtype=np.uint64).astype(np.uint32)
    hi[:2], lo[:2] = [0, 2**32 - 1], [2**32 - 1, 0]
    want = np.asarray(jl.pack2u32(jnp.asarray(hi), jnp.asarray(lo)))
    got = tl.pack2u32(hi, lo)
    assert got.dtype == np.uint64 and np.array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int8, np.uint16, np.int32, np.int64])
def test_canon_key_dtype_and_carrier_match_jax(dtype):
    info = np.iinfo(dtype)
    x = np.array([info.min, -1 if info.min < 0 else 0, 0, 1, info.max],
                 dtype)
    jx = jnp.asarray(x)
    want = np.asarray(jx.astype(jl.canon_key_dtype(jx)))
    assert tl.canon_key_dtype(x) == (torch.int64 if want.itemsize == 8
                                     else torch.int32)
    assert tl.canon_key_dtype(torch.from_numpy(x)) == tl.canon_key_dtype(x)
    got = carrier(x)
    assert np.array_equal(unsigned(got), want)


def test_u32_widens_to_u64_by_zero_extension():
    x = np.array([0, 1, 2**31, 2**32 - 1], np.uint32)
    got = tl.widen_u64(carrier(x))
    assert np.array_equal(unsigned(got), x.astype(np.uint64))
    assert tl.widen_u64(got) is got


def key_column(kind: str) -> np.ndarray:
    """2^13 u64 build keys: t=4-like (16 rows a key), zipf-like (a hot
    group), two hi planes, and uniform keys holding 2^64 - 1."""
    rng = np.random.default_rng({"t4": 2, "zipf": 3, "planes": 4,
                                 "max": 5}[kind])
    if kind == "t4":
        base = rng.integers(0, 2**64 - 1, N // 16, dtype=np.uint64)
        keys = base[rng.integers(0, base.size, N)]
    elif kind == "zipf":
        base = rng.integers(0, 2**64 - 1, 1 << 11, dtype=np.uint64)
        keys = base[(rng.zipf(1.3, N) - 1) % base.size]
    elif kind == "planes":
        hi = rng.integers(0, 2, N).astype(np.uint32) * np.uint32(0xFFFFFFFF)
        keys = tl.pack2u32(hi, rng.integers(0, 1 << 11, N))
    else:
        keys = rng.integers(0, 2**64 - 1, N, dtype=np.uint64) >> np.uint64(
            rng.integers(0, 60))
        keys[::97] = 2**64 - 1
    return keys


NESTED = ("main_pos_by_group", "bucket_main_len", "keys", "groups.ukey",
          "groups.group_start", "groups.group_len", "groups.group_rows",
          "groups.first_row", "groups.n_keys")
CHAINING = ("bucket_start", "bucket_len", "pos_by_row", "group_min_pos",
            "group_chain_first", "keys", "groups.ukey", "groups.group_start",
            "groups.group_len", "groups.group_rows", "groups.first_row",
            "groups.n_keys")


def field(table, name):
    for part in name.split("."):
        table = getattr(table, part)
    return table


def same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    if want.dtype == np.uint64:
        want = want.view(np.int64)
    elif want.dtype == np.uint32:
        want = want.view(np.int32)
    return tuple(got.shape) == want.shape and np.array_equal(got.numpy(),
                                                             want)


def fields_of(table, names):
    return {f: np.asarray(field(table, f)) for f in names}


@pytest.mark.parametrize("kind", ["t4", "zipf", "planes", "max"])
def test_compacted_builds_on_u64_keys_match_jax(kind):
    keys = key_column(kind)
    nb = max(1, np.unique(keys).size)
    jn = jax_nested(jnp.asarray(keys), nb)
    tn = build_nested_host(carrier(keys), nb)
    assert tn.groups.ukey.dtype == torch.int64
    for f in NESTED:
        assert same(field(tn, f), field(jn, f)), f
    for ee in (True, False):
        jc = jax_chaining(jnp.asarray(keys), nb, early_exit_index=ee)
        tc = build_chaining_host(carrier(keys), nb, early_exit_index=ee)
        for f in CHAINING:
            assert same(field(tc, f), field(jc, f)), (f, ee)
    # convert.py carries the u64 tables field for field
    cn = nested_table_from_numpy(fields_of(jn, NESTED_FIELDS),
                                 num_buckets=nb, hashfun=jn.hashfun,
                                 device="cpu")
    cc = chaining_table_from_numpy(
        fields_of(jc, CHAINING_FIELDS + OPTIONAL_FIELDS), num_buckets=nb,
        hashfun=jc.hashfun, device="cpu")
    assert cn.key_direct is None and cc.key_direct is None
    for f in NESTED:
        assert torch.equal(field(cn, f), field(tn, f)), f
    for f in CHAINING:
        assert torch.equal(field(cc, f), field(tc, f)), f


def test_u64_build_with_n_keys_and_a_key_domain_matches_jax():
    """The fused build (``n_keys`` given) on u64 keys below a domain: the
    key_direct map takes every key, the all-ones key stays out of it."""
    rng = np.random.default_rng(6)
    dom = 1 << 10
    keys = rng.integers(0, dom, N).astype(np.uint64)
    keys[::101] = 2**64 - 1
    nk = np.unique(keys).size
    jn = jax_nested(jnp.asarray(keys), nk, n_keys=nk, key_domain=dom)
    tn = build_nested_host(carrier(keys), nk, n_keys=nk, key_domain=dom)
    for f in NESTED + ("key_direct",):
        assert same(field(tn, f), field(jn, f)), f


def test_sorted_u64_keys_skip_the_sort_as_jax():
    keys = np.sort(key_column("max"))
    skey, srow, nk = tl.sort_with_rows(carrier(keys))
    jk, jr, jn = jl.sort_with_rows(jnp.asarray(keys))
    assert same(skey, jk) and same(srow, jr) and int(nk) == int(jn)
    assert tl.is_sorted_ascending(carrier(keys))
    assert not tl.is_sorted_ascending(carrier(keys[::-1]))
