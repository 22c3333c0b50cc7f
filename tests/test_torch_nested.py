"""The port's nested ("3D") table against the JAX package on the CPU.

Same seeded numpy inputs on both sides, exact equality everywhere (integer
work: the tolerance is zero):

* the dense-direct and the compacted builds of ``build_nested_host``,
  field by field, on uniform, t=4-like (16 rows a key) and zipf-like key
  columns (a hot group; the directory takes no windowed fetch);
* the layout pieces they use: ``sort_with_rows``, ``group_capacity`` and
  ``expand`` (counts with zeros, a truncated buffer, one large segment);
* ``keydirect_nested_strand_sorted`` with and without unnest, on the
  permutation route (P <= domain and P > domain) and the sorted route:
  counters equal, result pairs equal as multisets;
* ``HtStatistics.to_csv_fields`` and ``memory_consumption`` of both table
  kinds;
* the main chains (``main_pos_by_group``, ``bucket_main_len``, pads
  included) of the compacted, fused and clarity builds, which take them
  from ``runs.main_chains`` (kernel MC on the card, with no sort; its
  plain version here): uniform, t=4-like and zipf-like
  keys, the ``identity`` functor with every group in one bucket and with
  long buckets among short ones, ``drop_pad_key``'s dead group, no live
  group, a truncated directory, u64 keys and a ``valid`` mask;
* JAX-built nested tables (dense and compacted) carried across by
  ``convert.py`` and probed by the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hashjoin3d_tpu.ops import layout as jl
from hashjoin3d_tpu.ops import stats as jstats
from hashjoin3d_tpu.ops.chaining import build_chaining_host as jax_chaining
from hashjoin3d_tpu.ops.nested import _build_nested_fused as jax_fused
from hashjoin3d_tpu.ops.nested import build_nested as jax_clarity
from hashjoin3d_tpu.ops.nested import build_nested_host as jax_build
from hashjoin3d_tpu.ops.strands_windowed import (
    direct_probe_strand_sorted as jax_direct_strand,
    keydirect_nested_strand_sorted as jax_strand)

from hashjoin3d_tpu_torch.convert import (NESTED_DENSE_FIELDS, NESTED_FIELDS,
                                          nested_table_from_numpy)
from hashjoin3d_tpu_torch.ops import layout as tl
from hashjoin3d_tpu_torch.ops import stats as tstats
from hashjoin3d_tpu_torch.ops import strands_windowed as tw
from hashjoin3d_tpu_torch.ops.chaining import build_chaining_host
from hashjoin3d_tpu_torch.ops.chainwalk import bucket_ids
from hashjoin3d_tpu_torch.ops.nested import (_build_nested_fused,
                                             build_nested, build_nested_host)
from hashjoin3d_tpu_torch.ops.runs import main_chains_plain

N = 1 << 14
GROUP_FIELDS = ("ukey", "group_start", "group_len", "group_rows",
                "first_row")


def t32(a):
    return tl.from_numpy_u32(np.asarray(a), "cpu")


def same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    return got.shape == want.shape and np.array_equal(got.numpy(), want)


def key_column(kind: str) -> tuple[np.ndarray, int]:
    """(2^14 build keys, their key domain): uniform over 2^12 keys (4 rows
    a key), t=4-like over 2^10 (16 rows a key), zipf-like over 2^12 (a hot
    group at key 0)."""
    rng = np.random.default_rng({"uniform": 0, "t4": 1, "zipf": 2}[kind])
    if kind == "uniform":
        dom = 1 << 12
        keys = rng.integers(0, dom, N)
    elif kind == "t4":
        dom = 1 << 10
        keys = rng.integers(0, dom, N)
    else:
        dom = 1 << 12
        keys = (rng.zipf(1.3, N) - 1) % dom
    return keys.astype(np.uint32), dom


def builds(kind):
    keys, dom = key_column(kind)
    nk = np.unique(keys).size
    return (jax_build(keys, nk, n_keys=nk, key_domain=dom),
            build_nested_host(t32(keys), nk, n_keys=nk, key_domain=dom),
            keys, dom)


def pairs(out):
    prow, brow = np.asarray(out["probe_row"]), np.asarray(out["build_row"])
    hit = prow >= 0
    return sorted(zip(prow[hit].tolist(), brow[hit].tolist()))


@pytest.fixture(scope="module")
def uniform_tables():
    return builds("uniform")


def test_dense_nested_build_matches_jax():
    rng = np.random.default_rng(3)
    n, nb = 4096, 3000
    keys = rng.permutation(n).astype(np.uint32)
    want = jax_build(keys, nb, dense_direct=True, n_keys=n)
    got = build_nested_host(t32(keys), nb, dense_direct=True, n_keys=n)
    for f in ("direct", "bucket_main_len", "keys"):
        assert same(getattr(got, f), getattr(want, f)), f
    assert got.direct_shift == want.direct_shift
    assert int(got.groups.n_keys) == int(want.groups.n_keys) == n


@pytest.mark.parametrize("kind", ["uniform", "t4", "zipf"])
def test_compacted_nested_build_matches_jax(kind, monkeypatch):
    calls = []
    real = tw.safe_lookup
    monkeypatch.setattr(tw, "safe_lookup",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want, got, keys, dom = builds(kind)
    for f in GROUP_FIELDS:
        assert same(getattr(got.groups, f), getattr(want.groups, f)), f
    for f in ("main_pos_by_group", "bucket_main_len", "key_direct", "keys"):
        assert same(getattr(got, f), getattr(want, f)), f
    assert int(got.groups.n_keys) == int(want.groups.n_keys)
    # the directory is one pass over the sorted keys (ops/runs.py): no
    # windowed fetch at 4 rows a key or at 16
    assert calls == []
    assert got.groups.ukey.shape[0] == tl.group_capacity(
        np.unique(keys).size, N)


def test_compacted_build_without_n_keys_reads_it_back():
    keys, dom = key_column("t4")
    want = jax_build(keys, 100, key_domain=dom)
    got = build_nested_host(t32(keys), 100, key_domain=dom)
    for f in GROUP_FIELDS:
        assert same(getattr(got.groups, f), getattr(want.groups, f)), f
    assert same(got.main_pos_by_group, want.main_pos_by_group)
    assert same(got.bucket_main_len, want.bucket_main_len)


PAD = 2**32 - 1  # drop_pad_key's all-ones key
SHORT_CHAIN = 64  # MC's longest bucket ranked by counting (kShortChain)


def _host(keys, nb, n_keys=None, hashfun="murmur"):
    """Both packages' ``build_nested_host`` on one column."""
    nk = np.unique(keys).size if n_keys is None else n_keys
    t = torch.from_numpy(keys.view(np.int64 if keys.dtype == np.uint64
                                   else np.int32))
    return (jax_build(keys, nb, n_keys=nk, hashfun=hashfun),
            build_nested_host(t, nb, n_keys=nk, hashfun=hashfun))


def _identity_keys(long_sizes, nb, seed):
    """Distinct keys two rows each under the ``identity`` functor (bucket
    = key % nb): one bucket of each of ``long_sizes`` groups, the rest
    spread one or two a bucket, shuffled."""
    rng = np.random.default_rng(seed)
    parts = [(b + 7) + nb * np.arange(1, m + 1) for b, m in
             enumerate(long_sizes)]
    parts.append(rng.choice(nb * 1000, 3 * nb // 2, replace=False)
                 + nb * 9000)
    k = np.unique(np.concatenate(parts)).astype(np.uint32)
    return rng.permutation(np.repeat(k, 2))


def _fused(keys, nb, cap=None):
    """Both packages' fused build with ``drop_pad_key`` (a receive's dead
    all-ones rows) at the next power of two of the distinct keys."""
    cap = cap or tl.group_capacity(np.unique(keys).size, keys.size)
    return (jax_fused(keys, cap, nb, False, drop_pad_key=True),
            _build_nested_fused(t32(keys), cap, nb, False,
                                drop_pad_key=True))


def _clarity(keys, nb, live):
    return (jax_clarity(keys, nb, valid=live),
            build_nested(t32(keys), nb, valid=torch.from_numpy(live)))


def _pad_rows(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 600, 3000).astype(np.uint32)
    keys[rng.random(3000) < 0.2] = PAD
    return keys


MAIN_CHAIN_CASES = {
    "uniform": lambda: _host(key_column("uniform")[0], 3000),
    "t4": lambda: _host(key_column("t4")[0], 700),
    "zipf": lambda: _host(key_column("zipf")[0], 1000),
    "identity, one bucket": lambda: _host(
        np.repeat(np.arange(1, 301, dtype=np.uint32) * 97, 3), 97,
        hashfun="identity"),
    "identity, long buckets among short": lambda: _host(
        _identity_keys((SHORT_CHAIN, SHORT_CHAIN + 1, 200, 1100), 1000, 4),
        1000, hashfun="identity"),
    "drop_pad_key's dead group": lambda: _fused(_pad_rows(5), 401),
    "no live group": lambda: _fused(np.full(64, PAD, np.uint32), 13),
    "cap below n_keys": lambda: _host(key_column("t4")[0], 500,
                                      n_keys=300),
    "u64 keys": lambda: _host(
        key_column("uniform")[0].astype(np.uint64) * 0x9E3779B97F4A7C15,
        2000),
    "clarity, a valid mask": lambda: _clarity(
        _pad_rows(6), 300, np.random.default_rng(7).random(3000) < 0.6),
    "clarity, no valid row": lambda: _clarity(
        _pad_rows(8), 300, np.zeros(3000, bool)),
}


@pytest.mark.parametrize("case", MAIN_CHAIN_CASES)
def test_main_chains_match_jax(case):
    """The builds' main chains equal the JAX package's in full, the dead
    groups' entries included, and so does ``main_chains_plain`` on the
    port's bucket ids (the CPU path of every build)."""
    want, got = MAIN_CHAIN_CASES[case]()
    for f in ("main_pos_by_group", "bucket_main_len"):
        assert same(getattr(got, f), getattr(want, f)), f
    g = got.groups
    b = bucket_ids(g.ukey, got.num_buckets, got.hashfun,
                   live=g.group_len > 0)
    pos, blen = main_chains_plain(b, g.first_row, got.num_buckets)
    assert same(pos, want.main_pos_by_group)
    assert same(blen, want.bucket_main_len)


@pytest.mark.parametrize("presorted", [False, True])
def test_sort_with_rows_matches_jax(presorted):
    keys, _ = key_column("zipf")
    keys[:64] = 2**32 - 1 - np.arange(64, dtype=np.uint32)  # u32 order
    if presorted:
        keys = np.sort(keys)
    want = jl.sort_with_rows(jnp.asarray(keys))
    got = tl.sort_with_rows(t32(keys))
    for w, g in zip(want, got):
        assert same(g, w)


@pytest.mark.parametrize("n_keys,n", [(1, 8), (5, 64), (64, 64), (65, 1024),
                                      (1000, 700)])
def test_group_capacity_matches_jax(n_keys, n):
    assert tl.group_capacity(n_keys, n) == jl.group_capacity(n_keys, n)


@pytest.mark.parametrize("case", ["zeros", "truncated", "large_segment"])
def test_expand_matches_jax(case):
    rng = np.random.default_rng(4)
    P = 4096
    counts = rng.integers(0, 5, P).astype(np.int32)  # about 1 in 5 empty
    out_size = int(counts.sum())
    if case == "truncated":
        out_size = out_size * 2 // 3
    elif case == "large_segment":
        counts[1000] = 9000
        out_size = int(counts.sum())
    pay = rng.integers(-2**31, 2**31, P).astype(np.int32)
    want = jl.expand(jnp.asarray(counts), out_size, (jnp.asarray(pay),),
                     with_seg_len=True)
    got = tl.expand(torch.from_numpy(counts), out_size,
                    (torch.from_numpy(pay),), with_seg_len=True)
    assert len(got) == len(want) == 6
    valid = np.asarray(want[2])
    for i, (w, g) in enumerate(zip(want, got)):
        w = np.asarray(w)
        if i == 3:  # total
            assert int(g) == int(w)
        elif i == 1:  # within: defined on the valid slots
            assert np.array_equal(g.numpy()[valid], w[valid])
        else:
            assert same(g, w), i


@pytest.mark.parametrize("unnest", [True, False])
@pytest.mark.parametrize("route", ["permutation", "permutation_past_domain",
                                   "sorted"])
def test_keydirect_strand_matches_jax(uniform_tables, route, unnest):
    jt, pt, keys, dom = uniform_tables
    rng = np.random.default_rng(5)
    if route == "permutation":
        P = dom // 2
        pk = rng.permutation(P)
    elif route == "permutation_past_domain":
        P = 2 * dom
        pk = rng.permutation(P)
    else:
        P = 2 * dom
        pk = rng.integers(0, dom + dom // 8, P)  # 1 in 9 past the domain
    pk = pk.astype(np.uint32)
    perm = route != "sorted"
    out_size = int(np.bincount(keys, minlength=2 * dom)[pk].sum())
    want = jax_strand(jt, pk, out_size, do_unnest=unnest,
                      probes_permutation=perm)
    got = tw.keydirect_nested_strand_sorted(pt, t32(pk), out_size,
                                            do_unnest=unnest,
                                            probes_permutation=perm)
    keys_ = (("c_htProbe", "c_htProbeCmp") + (("c_unnest", "total")
                                              if unnest else ("c_top",)))
    for k in keys_:
        assert int(got[k]) == int(want[k]), k
    assert int(got["c_htProbe"]) < P  # the stream misses
    if unnest:
        assert pairs(got) == pairs(want)
        assert int(got["total"]) == out_size
    else:
        hit = np.asarray(want["nested_hit"])
        assert same(got["nested_hit"], hit)
        g_keys = lambda o: sorted(zip(  # noqa: E731
            np.asarray(o["nested_probe_row"])[hit].tolist(),
            np.asarray(o["nested_g"])[hit].tolist()))
        assert g_keys(got) == g_keys(want)


def test_statistics_and_memory_match_jax(uniform_tables):
    jt, pt, _, _ = uniform_tables
    assert (tstats.nested_statistics(pt).to_csv_fields()
            == jstats.nested_statistics(jt).to_csv_fields())
    assert pt.memory_consumption() == jt.memory_consumption()
    rng = np.random.default_rng(6)
    n = 4096
    rk = rng.permutation(n).astype(np.uint32)
    for full in (False, True):
        jc = jax_chaining(rk, 1000, dense_direct=True, n_keys=n,
                          full_chain_index=full)
        pc = build_chaining_host(t32(rk), 1000, dense_direct=True, n_keys=n,
                                 full_chain_index=full)
        assert (tstats.chaining_statistics(pc).to_csv_fields()
                == jstats.chaining_statistics(jc).to_csv_fields())
        assert pc.memory_consumption() == jc.memory_consumption()
    jd = jax_build(rk, 1000, dense_direct=True, n_keys=n)
    pd = build_nested_host(t32(rk), 1000, dense_direct=True, n_keys=n)
    assert (tstats.nested_statistics(pd).to_csv_fields()
            == jstats.nested_statistics(jd).to_csv_fields())
    assert pd.memory_consumption() == jd.memory_consumption()


def _jax_fields(table, names):
    out = {}
    for f in names:
        obj = table
        for part in f.split("."):
            obj = getattr(obj, part)
        out[f] = np.asarray(obj)
    return out


def test_port_probes_jax_built_nested_tables(uniform_tables):
    jt, _, keys, dom = uniform_tables
    port = nested_table_from_numpy(
        _jax_fields(jt, NESTED_FIELDS), num_buckets=jt.num_buckets,
        hashfun=jt.hashfun, device="cpu")
    pk = np.random.default_rng(7).permutation(dom).astype(np.uint32)
    out_size = int(np.bincount(keys, minlength=dom)[pk].sum())
    want = jax_strand(jt, pk, out_size, probes_permutation=True)
    got = tw.keydirect_nested_strand_sorted(port, t32(pk), out_size,
                                            probes_permutation=True)
    for k in ("c_htProbe", "c_htProbeCmp", "c_unnest"):
        assert int(got[k]) == int(want[k]), k
    assert pairs(got) == pairs(want)

    rng = np.random.default_rng(8)
    n = 4096
    rk = rng.permutation(n).astype(np.uint32)
    jd = jax_build(rk, 1000, dense_direct=True, n_keys=n)
    dense = nested_table_from_numpy(
        _jax_fields(jd, NESTED_DENSE_FIELDS), num_buckets=jd.num_buckets,
        hashfun=jd.hashfun, direct_shift=jd.direct_shift, device="cpu")
    pk = rng.integers(0, n + n // 4, 4 * n).astype(np.uint32)
    want = jax_direct_strand(jd, pk, nested=True)
    got = tw.direct_probe_strand_sorted(dense, t32(pk), nested=True)
    for k in ("c_htProbe", "c_htProbeCmp", "c_unnest", "total"):
        assert int(got[k]) == int(want[k]), k
    assert pairs(got) == pairs(want)
