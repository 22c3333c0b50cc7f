"""Port ops (hashjoin3d_tpu_torch.ops) against the JAX package, exactly.

Hashing, the run-structure primitives and the chaining builds take the
same seeded numpy inputs on both sides; every output is compared
bit for bit (integer work: the tolerance is zero).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hashjoin3d_tpu.ops import hashing as jh
from hashjoin3d_tpu.ops import layout as jl
from hashjoin3d_tpu.ops.chaining import (
    _build_chaining_dense as jax_build_dense)
from hashjoin3d_tpu.ops.chaining import build_chaining_host as jax_chaining

from hashjoin3d_tpu_torch.ops import hashing as th
from hashjoin3d_tpu_torch.ops import layout as tl
from hashjoin3d_tpu_torch.ops.chaining import (
    _build_chaining_dense, build_chaining_host, can_use_dense_direct)

EDGES = np.array([0, 1, 2, 1023, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1],
                 np.uint32)


def t32(a):
    return tl.from_numpy_u32(np.asarray(a), "cpu")


def u32(t):
    return t.numpy().view(np.uint32)


def test_murmur32_matches_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([EDGES, rng.integers(0, 2**32, 4096, np.uint64)
                        .astype(np.uint32)])
    want = np.asarray(jh.murmur32(jnp.asarray(x)))
    assert np.array_equal(u32(th.murmur32(t32(x))), want)
    assert np.array_equal(th.murmur32_np(x), want)


@pytest.mark.parametrize("nb", [1, 7, 64, 1000, 1 << 20, 2**31 + 11])
def test_bucket_of_matches_jax(nb):
    rng = np.random.default_rng(1)
    h = np.concatenate([EDGES, rng.integers(0, 2**32, 4096, np.uint64)
                        .astype(np.uint32)])
    want = np.asarray(jh.bucket_of(jnp.asarray(h), nb))
    got = th.bucket_of(t32(h), nb)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_hash_functor_other_than_murmur_names_its_slice():
    # every registry functor is ported now (tests/test_torch_keys64.py
    # holds each against the JAX package); a name outside the registry
    # raises and lists the registry's names
    with pytest.raises(ValueError, match="boncz"):
        th.hash_key(t32(EDGES), "crc")


@pytest.mark.parametrize("n_valid", [3000, 2500])
def test_run_boundaries_matches_jax(n_valid):
    rng = np.random.default_rng(2)
    skey = np.sort(rng.integers(0, 700, 3000)).astype(np.uint32)
    skey[-40:] = 2**32 - 1  # values past 2^31 in the carrier
    want = jl.run_boundaries(jnp.asarray(skey), n_valid)
    got = tl.run_boundaries(t32(skey), n_valid)
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy().astype(np.int64),
                              np.asarray(w).astype(np.int64))


def test_sorted_histogram_matches_jax():
    rng = np.random.default_rng(3)
    nb = 512
    b = np.sort(rng.integers(0, nb, 3000)).astype(np.int32)
    is_first, _, _, run_len = jl.run_boundaries(jnp.asarray(b), 3000)
    want = jl.sorted_histogram(jnp.asarray(b), nb, is_first, run_len)
    got = tl.sorted_histogram(
        torch.from_numpy(b), nb, torch.tensor(np.asarray(is_first)),
        torch.tensor(np.asarray(run_len)))
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_inverse_permute_matches_jax():
    rng = np.random.default_rng(4)
    perm = rng.permutation(4096).astype(np.int32)
    vals = rng.integers(-2**31, 2**31, 4096).astype(np.int32)
    want = np.asarray(jl.inverse_permute(jnp.asarray(perm), jnp.asarray(vals)))
    got = tl.inverse_permute(torch.from_numpy(perm), torch.from_numpy(vals))
    assert np.array_equal(got.numpy(), want)


def test_is_sorted_ascending_uses_u32_order():
    assert tl.is_sorted_ascending(t32(np.array([0, 5, 2**31, 2**32 - 1],
                                               np.uint32)))
    assert not tl.is_sorted_ascending(t32(np.array([2**31, 5], np.uint32)))
    assert tl.is_sorted_ascending(t32(np.array([7], np.uint32)))


@pytest.mark.parametrize("n,nb", [(1024, 1024), (4096, 4096), (4096, 300)])
def test_dense_build_matches_jax(n, nb):
    rng = np.random.default_rng(5)
    keys = rng.permutation(n).astype(np.uint32)
    assert can_use_dense_direct(keys, nb)
    want = jax_build_dense(jnp.asarray(keys), nb)
    got = _build_chaining_dense(t32(keys), nb)
    for f in ("direct", "bucket_len", "bucket_start", "pos_by_row", "keys"):
        assert np.array_equal(u32(getattr(got, f)),
                              np.asarray(getattr(want, f)).view(np.uint32)), f
    assert got.direct_shift == want.direct_shift
    assert got.num_buckets == want.num_buckets


def test_can_use_dense_direct_rejects_non_permutations():
    assert not can_use_dense_direct(np.array([0, 1, 1, 3], np.uint32), 4)
    assert not can_use_dense_direct(np.arange(6, dtype=np.uint32), 6)
    assert not can_use_dense_direct(np.arange(8, dtype=np.uint64), 8)


def test_generator_source_is_the_ports_own_copy():
    """The port compiles its own copy of the generator, never a file of the
    JAX package, and the copy is byte-equal to it (same streams)."""
    from pathlib import Path

    import hashjoin3d_tpu
    import hashjoin3d_tpu_torch
    from hashjoin3d_tpu_torch.utils import gen

    port = Path(hashjoin3d_tpu_torch.__file__).resolve().parent
    assert gen.GEN_SOURCE.resolve().is_relative_to(port)
    jax_src = (Path(hashjoin3d_tpu.__file__).resolve().parent / "native"
               / "hj3gen.cpp")
    assert gen.GEN_SOURCE.read_bytes() == jax_src.read_bytes()


def test_only_the_dense_build_is_ported():
    """Both builds of ``build_chaining_host``: without ``dense_direct`` the
    compacted one (here with one count read back), equal to the JAX
    package's; with it the dense one and its full chain index (CsrUU)."""
    keys = t32(np.arange(16, dtype=np.uint32))
    want = jax_chaining(np.arange(16, dtype=np.uint32) // 2, 16)
    got = build_chaining_host(keys // 2, 16)
    assert got.direct is None and int(got.groups.n_keys) == 8
    for f in ("bucket_len", "pos_by_row", "group_min_pos",
              "group_chain_first"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    tbl = build_chaining_host(keys, 16, dense_direct=True, n_keys=16,
                              full_chain_index=True)
    want = tbl.bucket_len[th.bucket_of(th.hash_key(keys), 16).long()]
    assert torch.equal(tbl.chain_by_key, want)
