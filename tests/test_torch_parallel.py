"""The port's distributed joins on 4 gloo ranks of the CPU.

The ranks are spawned once for the module (``tests/torch_ranks.py``: a
``FileStore`` under the test's tmp directory, one thread a rank, no
``jax`` in them); every case splits seeded numpy columns into 4 equal
blocks, runs one entry point of ``hashjoin3d_tpu_torch.parallel`` on all
ranks and holds the gathered result to ``tests/oracle.py`` semantics
(numpy pair lists), to numpy aggregates, or to the port's single-chip
ops.  These are the cases of ``tests/test_parallel.py`` (the JAX
package's suite on its 8-device mesh) on a 4-rank mesh, plus the port's
own: the exchange's layout, ``num_cmps`` against the single-chip engine
on each shard's arrival-order table, the mesh's rules and a 1-rank group
started by ``make_mesh`` itself.  Integer results: the tolerance is zero.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hashjoin3d_tpu_torch.ops.hashing import hash_key_np
from hashjoin3d_tpu_torch.ops.layout import key_column
from hashjoin3d_tpu_torch.ops.chaining import build_chaining, probe_chaining
from hashjoin3d_tpu_torch.ops.nested import build_nested, probe_nested
from hashjoin3d_tpu_torch.parallel import detect_skew, suggest_capacity

from torch_ranks import RankPool, gathered, pairs, triples

NS = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(NS, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield p
    p.close()


def run(pool, entry, columns, mesh_kind="flat", **kwargs):
    return gathered(pool.run("run_step", entry, kwargs, list(columns),
                             mesh_kind))


def oracle_pairs(bk, pk):
    return sorted((p, int(b)) for p, k in enumerate(pk)
                  for b in np.nonzero(bk == k)[0])


def shard_np(keys, ns=NS):
    """The host mirror of ``shard_of_key``."""
    return (hash_key_np(hash_key_np(keys)) % keys.dtype.type(ns)).astype(
        np.int64)


def arrival_counters(bk, pk, nb, kind="nested", unique=False):
    """The single-chip engine's (matches, cmps) summed over the shards,
    each shard's table built on its keys in arrival order (the global
    order, filtered by owner), each shard probed by its own keys."""
    m = c = 0
    sb, sp = shard_np(bk), shard_np(pk)
    for s in range(NS):
        b = key_column(bk[sb == s], "cpu")
        p = key_column(pk[sp == s], "cpu")
        if kind == "nested":
            res = probe_nested(build_nested(b, nb), p)
        else:
            res = probe_chaining(build_chaining(b, nb,
                                                early_exit_index=unique), p,
                                 unique=unique)
        m, c = m + int(res.num_matches), c + int(res.num_cmps)
    return m, c


def uniform_or_skewed(seed, skewed, n_b=1024, n_p=2048):
    rng = np.random.default_rng(seed)
    if skewed:
        bk = np.minimum(rng.zipf(1.2, n_b), 300).astype(np.uint32)
    else:
        bk = rng.integers(0, 500, n_b, dtype=np.uint32)
    pk = rng.integers(0, 600, n_p, dtype=np.uint32)
    return bk, pk


COUNTERS = ("num_matches", "num_cmps", "num_unnested")


@pytest.mark.parametrize("skewed", [False, True])
def test_dist_nested_join_matches_oracle(pool, skewed):
    bk, pk = uniform_or_skewed(11, skewed)
    c, rows = run(pool, "dist_nested_join", (bk, pk),
                  num_buckets_per_shard=64, build_capacity=bk.size,
                  probe_capacity=pk.size, out_capacity=8 * pk.size)
    assert c["overflow"] == 0
    want = oracle_pairs(bk, pk)
    assert pairs(rows) == want
    res = probe_nested(build_nested(key_column(bk, "cpu"), 64),
                       key_column(pk, "cpu"))
    assert c["num_matches"] == int(res.num_matches)
    assert c["num_unnested"] == len(want)
    assert (c["num_matches"], c["num_cmps"]) == arrival_counters(bk, pk, 64)


def test_dist_chaining_join_matches_oracle(pool):
    rng = np.random.default_rng(5)
    bk = rng.integers(0, 100, 512, dtype=np.uint32)
    pk = rng.integers(0, 130, 1024, dtype=np.uint32)
    c, rows = run(pool, "dist_chaining_join", (bk, pk),
                  num_buckets_per_shard=32, build_capacity=512,
                  probe_capacity=1024, out_capacity=8 * 1024)
    assert c["overflow"] == 0
    assert pairs(rows) == oracle_pairs(bk, pk)
    assert c["num_results"] == len(oracle_pairs(bk, pk))
    assert (c["num_matches"], c["num_cmps"]) == arrival_counters(
        bk, pk, 32, "chaining")


def test_dist_overflow_detected(pool):
    """An undersized capacity reports its dropped rows, exactly."""
    bk = np.full(256, 7, np.uint32)  # all rows route to one shard
    pk = np.array([7] * 8, np.uint32)
    c, rows = run(pool, "dist_nested_join", (bk, pk),
                  num_buckets_per_shard=8, build_capacity=16,
                  probe_capacity=8, out_capacity=4096)
    # each rank ships 64 rows of key 7 and keeps 16
    assert c["overflow"] == NS * (64 - 16)
    assert c["num_unnested"] == 8 * NS * 16
    assert rows["out_valid"].sum() == c["num_unnested"]


def test_broadcast_join_matches_oracle(pool):
    rng = np.random.default_rng(21)
    bk = np.concatenate([np.full(64, 5, np.uint32),
                         rng.integers(0, 100, 192, dtype=np.uint32)])
    rng.shuffle(bk)
    pk = np.concatenate([np.full(512, 5, np.uint32),
                         rng.integers(0, 120, 512, dtype=np.uint32)])
    rng.shuffle(pk)
    rep = detect_skew(pk, NS)
    assert rep["strategy"] in ("broadcast", "hybrid")
    assert rep["top_key_fraction"] > 0.4
    c, rows = run(pool, "dist_broadcast_join", (bk, pk), num_buckets=64,
                  out_capacity=16 * 1024, nested=True)
    want = oracle_pairs(bk, pk)
    assert pairs(rows) == want
    assert c["num_unnested"] == len(want)
    # every shard probes the whole table with its own rows
    res = probe_nested(build_nested(key_column(bk, "cpu"), 64),
                       key_column(pk, "cpu"))
    assert (c["num_matches"], c["num_cmps"]) == (int(res.num_matches),
                                                 int(res.num_cmps))
    for unique in (False, True):
        bku = np.unique(bk) if unique else bk
        bku = bku[:bku.size - bku.size % NS]
        c, rows = run(pool, "dist_broadcast_join", (bku, pk),
                      num_buckets=64, out_capacity=16 * 1024, nested=False,
                      unique=unique)
        assert pairs(rows) == oracle_pairs(bku, pk)
        tbl = build_chaining(key_column(bku, "cpu"), 64,
                             early_exit_index=unique)
        res = probe_chaining(tbl, key_column(pk, "cpu"), unique=unique)
        assert (c["num_matches"], c["num_cmps"]) == (int(res.num_matches),
                                                     int(res.num_cmps))


def test_suggest_capacity():
    assert suggest_capacity(1024, 8, 1.0) >= 1024 // 8
    assert suggest_capacity(1024, 8, 4.0) > suggest_capacity(1024, 8, 1.0)
    assert suggest_capacity(1024, 8, 1.0) == int(128 * 1.25) + 64


def _pipeline_oracle(bk, bv, pk, keep):
    joined = [(int(k), int(bv[b])) for k, ok in zip(pk, keep) if ok
              for b in np.nonzero(bk == k)[0]]
    groups = {}
    for k, v in joined:
        n, s = groups.get(k, (0, 0))
        groups[k] = (n + 1, s + v)
    return joined, groups


def _pipeline_groups(rows):
    got = {}
    for k, n, s in zip(rows["group_keys"], rows["group_count"],
                       rows["group_sum"]):
        if n > 0:
            k = int(k)
            assert k not in got, "a key lives on one shard only"
            got[k] = (int(n), int(s))
    return got


def test_dist_filter_join_aggregate(pool):
    rng = np.random.default_rng(33)
    n_b, n_p = 512, 1024
    bk = rng.integers(0, 120, n_b, dtype=np.uint32)
    bv = rng.integers(0, 50, n_b, dtype=np.int32)
    pk = rng.integers(0, 150, n_p, dtype=np.uint32)
    pp = rng.integers(0, 100, n_p, dtype=np.int32)
    c, rows = run(pool, "dist_filter_join_aggregate", (bk, bv, pk, pp),
                  num_buckets_per_shard=32, build_capacity=n_b,
                  probe_capacity=n_p, out_capacity=8 * n_p,
                  predicate="below_60")
    assert c["overflow"] == 0
    keep = pp < 60
    joined, want = _pipeline_oracle(bk, bv, pk, keep)
    assert c["num_filtered"] == int(keep.sum())
    assert c["num_joined"] == len(joined)
    assert c["sum_v"] == sum(v for _, v in joined)
    assert c["n_groups"] == len(want)
    assert _pipeline_groups(rows) == want


def test_pipeline_u64_keys_not_merged(pool):
    k1, k2 = np.uint64(7), np.uint64((1 << 33) | 7)
    bk = np.array([k1, k2] * 128, np.uint64)
    bv = np.arange(256, dtype=np.int32) % 10
    pk = np.array([k1, k2] * 64, np.uint64)
    pp = np.zeros(128, np.int32)
    c, rows = run(pool, "dist_filter_join_aggregate", (bk, bv, pk, pp),
                  num_buckets_per_shard=16, build_capacity=256,
                  probe_capacity=128, out_capacity=65536,
                  predicate="below_1")
    assert c["overflow"] == 0
    live = {int(np.int64(k).view(np.uint64))
            for k, n in zip(rows["group_keys"], rows["group_count"])
            if n > 0}
    assert live == {int(k1), int(k2)}
    _, want = _pipeline_oracle(bk, bv, pk, pp < 1)
    assert c["n_groups"] == 2 and c["num_joined"] == 128 * 128


@pytest.mark.parametrize("skewed", [False, True])
def test_ring_join_matches_all_to_all(pool, skewed):
    rng = np.random.default_rng(17)
    n_b, n_p = 1024, 2048
    if skewed:
        pk = np.minimum(rng.zipf(1.2, n_p), 400).astype(np.uint32)
    else:
        pk = rng.integers(0, 600, n_p, dtype=np.uint32)
    bk = rng.integers(0, 500, n_b, dtype=np.uint32)
    out_cap = 16 * n_p
    c, rows = run(pool, "dist_ring_nested_join", (bk, pk),
                  num_buckets_per_shard=64, build_capacity=n_b,
                  out_capacity=out_cap, step_out_capacity=out_cap // 2)
    assert c["overflow"] == 0
    want = oracle_pairs(bk, pk)
    assert pairs(rows) == want
    assert c["num_unnested"] == len(want)
    c2, rows2 = run(pool, "dist_nested_join", (bk, pk),
                    num_buckets_per_shard=64, build_capacity=n_b,
                    probe_capacity=4 * n_p, out_capacity=out_cap)
    assert c["num_matches"] == c2["num_matches"]
    assert pairs(rows2) == want
    # every probe meets every shard's table once
    sb = shard_np(bk)
    cmps = sum(int(probe_nested(build_nested(key_column(bk[sb == s], "cpu"),
                                             64),
                                key_column(pk, "cpu")).num_cmps)
               for s in range(NS))
    assert c["num_cmps"] == cmps


def test_hier_2d_join_matches_flat(pool):
    rng = np.random.default_rng(29)
    n_b, n_p = 1024, 2048
    bk = rng.integers(0, 500, n_b, dtype=np.uint32)
    pk = rng.integers(0, 600, n_p, dtype=np.uint32)
    kw = dict(num_buckets_per_shard=64, build_capacity=n_b,
              probe_capacity=n_p, out_capacity=16 * n_p)
    c, rows = run(pool, "dist_nested_join_2d", (bk, pk), "2d", **kw)
    assert c["overflow"] == 0
    want = oracle_pairs(bk, pk)
    assert pairs(rows) == want
    assert c["num_unnested"] == len(want)
    flat, _ = run(pool, "dist_nested_join", (bk, pk), **kw)
    # two hops land every row where the flat exchange does, in its order
    assert {k: c[k] for k in COUNTERS} == {k: flat[k] for k in COUNTERS}


def test_hybrid_join_survives_skew_that_overflows_flat(pool):
    rng = np.random.default_rng(41)
    n_b, n_p = 1024, 4096
    hot = 123
    bk = np.concatenate([np.full(8, hot, np.uint32),
                         rng.integers(0, 400, n_b - 8, dtype=np.uint32)])
    rng.shuffle(bk)
    pk = np.concatenate([np.full(n_p // 2, hot, np.uint32),
                         rng.integers(0, 500, n_p // 2, dtype=np.uint32)])
    rng.shuffle(pk)
    rep = detect_skew(pk, NS)
    assert rep["strategy"] == "hybrid"
    assert hot in rep["hot_keys"].tolist()
    tight_cap = int(n_p / NS / NS * 1.5)
    kw = dict(num_buckets_per_shard=64, build_capacity=n_b,
              out_capacity=16 * n_p)
    flat_tight, _ = run(pool, "dist_nested_join", (bk, pk),
                        probe_capacity=tight_cap, **kw)
    assert flat_tight["overflow"] > 0
    c, rows = run(pool, "dist_hybrid_nested_join", (bk, pk),
                  hot_keys=rep["hot_keys"].tolist(), probe_capacity=tight_cap,
                  hot_build_capacity=64, **kw)
    assert c["overflow"] == 0
    want = oracle_pairs(bk, pk)
    assert pairs(rows) == want
    assert c["num_unnested"] == len(want)
    ok, _ = run(pool, "dist_nested_join", (bk, pk),
                probe_capacity=tight_cap * NS, **kw)
    assert ok["overflow"] == 0 and ok["num_matches"] == c["num_matches"]


def test_hybrid_survives_exp1_zipf_where_flat_overflows(pool):
    """exp-1's own zipf(1.0) S.a at R8/S12 (the headline's S = R + 4)
    overflows a uniformly sized flat exchange, and the hybrid join
    replicating ``top_keys`` survives with the same cold capacity,
    counters and pairs exact.  The receive volumes are measured on the
    host (the routing's mirror), so the capacity claims are not
    circular."""
    from hashjoin3d_tpu_torch.utils.gen import exp1_data

    rk, sa, _ = exp1_data(8, 12, True, 0)
    n_p, n_b = sa.size, rk.size
    top = detect_skew(sa, NS)["top_keys"]
    assert len(top) == 16

    def max_src_dst(keys, mask=None):
        d = shard_np(keys)
        src = np.arange(keys.size) // (keys.size // NS)
        w = None if mask is None else mask.astype(np.int64)
        return int(np.bincount(src * NS + d, weights=w,
                               minlength=NS * NS).max())

    uniform_cap = int(n_p / NS / NS * 1.25)
    assert max_src_dst(sa) > uniform_cap
    assert max_src_dst(sa, ~np.isin(sa, top)) <= uniform_cap
    kw = dict(num_buckets_per_shard=1 << 6, build_capacity=n_b,
              probe_capacity=uniform_cap, out_capacity=2 * (n_p // NS))
    flat, _ = run(pool, "dist_nested_join", (rk, sa), **kw)
    assert flat["overflow"] > 0
    c, rows = run(pool, "dist_hybrid_nested_join", (rk, sa),
                  hot_keys=top.tolist(), hot_build_capacity=32, **kw)
    assert c["overflow"] == 0
    assert c["num_matches"] == n_p and c["num_unnested"] == n_p
    inv = np.empty(n_b, np.int64)
    inv[rk] = np.arange(n_b)
    assert pairs(rows) == sorted((p, int(inv[k])) for p, k in enumerate(sa))


def test_ring_join_step_truncation_reported(pool):
    bk = np.full(16, 5, np.uint32)
    pk = np.full(16, 5, np.uint32)
    c, rows = run(pool, "dist_ring_nested_join", (bk, pk),
                  num_buckets_per_shard=8, build_capacity=16,
                  out_capacity=256, step_out_capacity=8)
    assert c["overflow"] > 0
    v = rows["out_valid"]
    assert (rows["probe_row"][v] >= 0).all()
    assert (rows["build_row"][v] >= 0).all()
    assert c["num_unnested"] == 16 * 16
    # only the key's owner emits: 4 probes x 16 rows a chunk, 8 kept
    assert c["overflow"] == 16 * 16 - int(v.sum())


def test_detect_skew_hybrid_requires_full_hot_coverage():
    pk = np.repeat(np.arange(40, dtype=np.uint32), 100)
    assert detect_skew(pk, 64, max_hot=16)["strategy"] != "hybrid"
    rep = detect_skew(pk, 64, max_hot=40)
    assert rep["strategy"] == "hybrid"
    assert len(rep["hot_keys"]) == 40


def test_detect_skew_u64_and_sampling():
    """u64 keys take the 64-bit routing mirror; past ``sample`` rows the
    report reads a seeded sample."""
    rng = np.random.default_rng(3)
    base = (np.arange(64, dtype=np.uint64) << np.uint64(36)) | np.uint64(9)
    pk = np.concatenate([np.full(3000, base[0]),
                         rng.choice(base, 1000)]).astype(np.uint64)
    rep = detect_skew(pk, NS, sample=1 << 20)
    assert rep["top_keys"][0] == base[0] and rep["strategy"] == "hybrid"
    d = shard_np(pk)
    loads = np.bincount(d, minlength=NS)
    assert rep["shard_imbalance"] == loads.max() / loads.mean()
    assert detect_skew(pk, NS, sample=512)["top_key_fraction"] > 0.6


def test_dist_deferred_two_join_matches_exp4_oracle(pool):
    from hashjoin3d_tpu_torch.models.exp4 import Experiment4
    from hashjoin3d_tpu_torch.utils.gen import exp4_data

    exp = Experiment4(8, 2, 2, 3, 2, plans=("Ndu",), device="cpu")
    sa, ta = exp4_data(8, 2, 2, 3, 2)
    rk = np.arange(exp.card_r, dtype=np.uint32)
    want = sorted((int(k), int(si), int(ti)) for k in rk
                  for si in np.nonzero(sa == k)[0]
                  for ti in np.nonzero(ta == k)[0])
    assert len(want) == exp.calc_join_card2()
    c, rows = run(pool, "dist_deferred_two_join", (rk, sa, ta),
                  num_buckets_per_shard=64, fk_capacity=sa.size,
                  r_capacity=rk.size, out1_capacity=4 * len(want),
                  out2_capacity=4 * len(want))
    assert c["overflow"] == 0
    assert c["c_top"] == exp.calc_join_card2()
    assert c["c_probe_RS"] == exp.num_fk_common + exp.num_fk_exclusive
    assert c["c_probe_RT"] == exp.num_fk_common
    assert triples(rows) == want


def _u64_base():
    rng = np.random.default_rng(67)
    base = (rng.choice(1 << 20, 96, replace=False).astype(np.uint64)
            << np.uint64(40)) | np.uint64(0xABCDEF)
    bk = np.repeat(base[:64], rng.integers(1, 6, 64)).astype(np.uint64)
    rng.shuffle(bk)
    pk = rng.choice(base, 256).astype(np.uint64)
    return bk[:bk.size - bk.size % NS], pk


def test_dist_join_u64_merged_strand(pool):
    bk, pk = _u64_base()
    kw = dict(num_buckets_per_shard=16, build_capacity=bk.size,
              probe_capacity=256, out_capacity=4096)
    out_m, rows_m = run(pool, "dist_nested_join", (bk, pk), **kw)
    out_g, rows_g = run(pool, "dist_nested_join", (bk, pk), merged=False,
                        **kw)
    assert out_m["overflow"] == 0
    assert pairs(rows_m) == pairs(rows_g) == oracle_pairs(bk, pk)
    for k in COUNTERS:
        assert out_m[k] == out_g[k], k
    assert (out_m["num_matches"], out_m["num_cmps"]) == arrival_counters(
        bk, pk, 16)
    outc_m, rc_m = run(pool, "dist_chaining_join", (bk, pk), **kw)
    outc_g, rc_g = run(pool, "dist_chaining_join", (bk, pk), merged=False,
                       **kw)
    assert pairs(rc_m) == pairs(rc_g) == oracle_pairs(bk, pk)
    for k in ("num_matches", "num_cmps", "num_results"):
        assert outc_m[k] == outc_g[k], k


def _collide_u64():
    rng = np.random.default_rng(61)
    base = (np.arange(256, dtype=np.uint64) << np.uint64(33)) | np.uint64(7)
    bk = np.repeat(base[:128], 4).astype(np.uint64)
    rng.shuffle(bk)
    # same low 32 bits, different high bits: they collide if truncated
    pk = np.concatenate([base[:200], base[:56] ^ np.uint64(1 << 37)])
    rng.shuffle(pk)
    return bk, pk


def test_dist_join_u64_keys(pool):
    bk, pk = _collide_u64()
    c, rows = run(pool, "dist_nested_join", (bk, pk),
                  num_buckets_per_shard=32, build_capacity=512,
                  probe_capacity=256, out_capacity=8192)
    assert c["overflow"] == 0
    assert pairs(rows) == oracle_pairs(bk, pk)


def test_hier_2d_join_u64_keys(pool):
    bk, pk = _collide_u64()
    c, rows = run(pool, "dist_nested_join_2d", (bk, pk), "2d",
                  num_buckets_per_shard=32, build_capacity=512,
                  probe_capacity=256, out_capacity=8192)
    assert c["overflow"] == 0
    assert pairs(rows) == oracle_pairs(bk, pk)


@pytest.mark.parametrize("prefetch", [True, False])
def test_chunked_flat_join_matches_one_shot(pool, prefetch):
    rng = np.random.default_rng(73)
    n_b, n_p = 1024, 4096
    bk = rng.integers(0, 500, n_b, dtype=np.uint32)
    pk = rng.integers(0, 600, n_p, dtype=np.uint32)
    c, rows = run(pool, "dist_nested_join_chunked", (bk, pk),
                  num_buckets_per_shard=64, build_capacity=n_b,
                  probe_capacity=n_p, out_capacity=16 * n_p, n_chunks=4,
                  prefetch=prefetch)
    assert c["overflow"] == 0
    want = oracle_pairs(bk, pk)
    assert pairs(rows) == want
    ref, _ = run(pool, "dist_nested_join", (bk, pk),
                 num_buckets_per_shard=64, build_capacity=n_b,
                 probe_capacity=n_p, out_capacity=16 * n_p)
    assert {k: c[k] for k in COUNTERS} == {k: ref[k] for k in COUNTERS}


def test_ring_join_prefetch_matches_sequential(pool):
    rng = np.random.default_rng(74)
    n_b, n_p = 512, 1024
    bk = rng.integers(0, 300, n_b, dtype=np.uint32)
    pk = rng.integers(0, 400, n_p, dtype=np.uint32)
    outs = []
    for prefetch in (True, False):
        c, rows = run(pool, "dist_ring_nested_join", (bk, pk),
                      num_buckets_per_shard=32, build_capacity=n_b,
                      out_capacity=8 * n_p, step_out_capacity=4 * n_p,
                      prefetch=prefetch)
        assert c["overflow"] == 0
        outs.append((c, pairs(rows)))
    assert outs[0] == outs[1]
    assert outs[0][1] == oracle_pairs(bk, pk)


def test_dist_join_windowed_probe_matches_default(pool):
    rng = np.random.default_rng(77)
    n_b, n_p = 1024, 4096
    bk = rng.integers(0, 500, n_b, dtype=np.uint32)
    pk = rng.integers(0, 600, n_p, dtype=np.uint32)
    kw = dict(num_buckets_per_shard=64, build_capacity=n_b,
              probe_capacity=n_p, out_capacity=16 * n_p)
    base, rb = run(pool, "dist_nested_join", (bk, pk), **kw)
    win, rw = run(pool, "dist_nested_join", (bk, pk), key_domain=600, **kw)
    assert win["overflow"] == 0
    assert {k: win[k] for k in COUNTERS} == {k: base[k] for k in COUNTERS}
    assert pairs(rw) == pairs(rb) == oracle_pairs(bk, pk)


def test_ring_join_windowed_probe_matches_default(pool):
    rng = np.random.default_rng(79)
    n_b, n_p = 1024, 2048
    bk = rng.integers(0, 500, n_b, dtype=np.uint32)
    pk = rng.integers(0, 600, n_p, dtype=np.uint32)
    kw = dict(num_buckets_per_shard=64, build_capacity=n_b,
              out_capacity=16 * n_p, step_out_capacity=8 * n_p)
    base, rb = run(pool, "dist_ring_nested_join", (bk, pk), **kw)
    win, rw = run(pool, "dist_ring_nested_join", (bk, pk), key_domain=600,
                  **kw)
    assert win["overflow"] == 0
    assert {k: win[k] for k in COUNTERS} == {k: base[k] for k in COUNTERS}
    assert pairs(rw) == pairs(rb) == oracle_pairs(bk, pk)


def test_hier_2d_join_windowed_probe_matches_default(pool):
    rng = np.random.default_rng(83)
    n_b, n_p = 1024, 2048
    bk = rng.integers(0, 500, n_b, dtype=np.uint32)
    pk = rng.integers(0, 600, n_p, dtype=np.uint32)
    kw = dict(num_buckets_per_shard=64, build_capacity=n_b,
              probe_capacity=n_p, out_capacity=16 * n_p)
    base, rb = run(pool, "dist_nested_join_2d", (bk, pk), "2d", **kw)
    win, rw = run(pool, "dist_nested_join_2d", (bk, pk), "2d",
                  key_domain=600, **kw)
    assert win["overflow"] == 0
    assert {k: win[k] for k in COUNTERS} == {k: base[k] for k in COUNTERS}
    assert pairs(rw) == pairs(rb) == oracle_pairs(bk, pk)


def _unique_or_not(seed, unique, n_b=1024, n_p=2048):
    rng = np.random.default_rng(seed)
    if unique:
        bk = rng.permutation(2048)[:n_b].astype(np.uint32)
        dom, nk = 2048, 2048
    else:
        bk = rng.integers(0, 500, n_b, dtype=np.uint32)
        dom, nk = 600, 500
    pk = rng.integers(0, dom, n_p, dtype=np.uint32)
    return bk, pk, dom, nk


@pytest.mark.parametrize("unique", [False, True])
def test_dist_chaining_windowed_probe_matches_default(pool, unique):
    bk, pk, dom, _ = _unique_or_not(91, unique)
    kw = dict(num_buckets_per_shard=64, build_capacity=bk.size,
              probe_capacity=pk.size, out_capacity=16 * pk.size,
              unique=unique)
    base, rb = run(pool, "dist_chaining_join", (bk, pk), **kw)
    win, rw = run(pool, "dist_chaining_join", (bk, pk), key_domain=dom, **kw)
    assert win["overflow"] == 0
    for k in ("num_matches", "num_cmps", "num_results"):
        assert win[k] == base[k], k
    assert pairs(rw) == pairs(rb)
    assert (base["num_matches"], base["num_cmps"]) == arrival_counters(
        bk, pk, 64, "chaining", unique)


@pytest.mark.parametrize("skewed", [False, True])
def test_dist_nested_join_fast_path_matches_default(pool, skewed):
    bk, pk = uniform_or_skewed(97, skewed)
    kw = dict(num_buckets_per_shard=64, build_capacity=bk.size,
              probe_capacity=pk.size, out_capacity=16 * pk.size)
    base, rb = run(pool, "dist_nested_join", (bk, pk), **kw)
    fast, rf = run(pool, "dist_nested_join", (bk, pk), key_domain=600,
                   n_keys=600, **kw)
    assert fast["overflow"] == 0
    assert {k: fast[k] for k in COUNTERS} == {k: base[k] for k in COUNTERS}
    assert pairs(rf) == pairs(rb) == oracle_pairs(bk, pk)


def test_dist_nested_join_n_keys_without_key_domain(pool):
    rng = np.random.default_rng(101)
    bk = rng.integers(0, 300, 512, dtype=np.uint32)
    pk = rng.integers(0, 400, 1024, dtype=np.uint32)
    kw = dict(num_buckets_per_shard=32, build_capacity=512,
              probe_capacity=1024, out_capacity=16 * 1024)
    base, rb = run(pool, "dist_nested_join", (bk, pk), **kw)
    fast, rf = run(pool, "dist_nested_join", (bk, pk), n_keys=300, **kw)
    assert fast["overflow"] == 0
    assert {k: fast[k] for k in COUNTERS} == {k: base[k] for k in COUNTERS}
    assert pairs(rf) == pairs(rb) == oracle_pairs(bk, pk)


@pytest.mark.parametrize("unique", [False, True])
def test_dist_chaining_join_fast_path_matches_default(pool, unique):
    bk, pk, dom, nk = _unique_or_not(103, unique)
    kw = dict(num_buckets_per_shard=64, build_capacity=bk.size,
              probe_capacity=pk.size, out_capacity=16 * pk.size,
              unique=unique)
    base, rb = run(pool, "dist_chaining_join", (bk, pk), **kw)
    fast, rf = run(pool, "dist_chaining_join", (bk, pk), key_domain=dom,
                   n_keys=nk, **kw)
    assert fast["overflow"] == 0
    for k in ("num_matches", "num_cmps", "num_results"):
        assert fast[k] == base[k], k
    assert pairs(rf) == pairs(rb) == oracle_pairs(bk, pk)


@pytest.mark.parametrize("skewed", [False, True])
def test_ring_join_fast_path_matches_default(pool, skewed):
    bk, pk = uniform_or_skewed(107, skewed)
    kw = dict(num_buckets_per_shard=64, build_capacity=bk.size,
              out_capacity=16 * pk.size, step_out_capacity=8 * pk.size)
    base, rb = run(pool, "dist_ring_nested_join", (bk, pk), **kw)
    fast, rf = run(pool, "dist_ring_nested_join", (bk, pk), key_domain=600,
                   n_keys=600, **kw)
    assert fast["overflow"] == 0
    assert {k: fast[k] for k in COUNTERS} == {k: base[k] for k in COUNTERS}
    assert pairs(rf) == pairs(rb) == oracle_pairs(bk, pk)


def test_hier_2d_join_fast_path_matches_default(pool):
    rng = np.random.default_rng(109)
    bk = rng.integers(0, 500, 1024, dtype=np.uint32)
    pk = rng.integers(0, 600, 2048, dtype=np.uint32)
    kw = dict(num_buckets_per_shard=64, build_capacity=1024,
              probe_capacity=2048, out_capacity=16 * 2048)
    base, rb = run(pool, "dist_nested_join_2d", (bk, pk), "2d", **kw)
    fast, rf = run(pool, "dist_nested_join_2d", (bk, pk), "2d",
                   key_domain=600, n_keys=600, **kw)
    assert fast["overflow"] == 0
    assert {k: fast[k] for k in COUNTERS} == {k: base[k] for k in COUNTERS}
    assert pairs(rf) == pairs(rb) == oracle_pairs(bk, pk)


@pytest.mark.parametrize("u64", [False, True])
@pytest.mark.parametrize("sort_within_dest", [False, True])
def test_partition_exchange_layout(pool, u64, sort_within_dest):
    """Each receive block holds one source's rows for this shard, in the
    source's order (or ascending by key, unsigned), then a dead tail on
    the all-ones key with -1 rows; a short capacity drops and counts."""
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 1 << 32, 1024, dtype=np.uint64)
    keys[::9] = 0xFFFFFFF0 + (keys[::9] % 8)  # keys >= 2^31 sort unsigned
    if u64:
        keys = (keys << np.uint64(31)) | np.uint64(3)
    else:
        keys = keys.astype(np.uint32)
    cap = 64
    got = pool.run("exchange", keys, cap, sort_within_dest)
    d = shard_np(keys)
    pad = np.iinfo(keys.dtype).max
    n_local = keys.size // NS
    dropped = 0
    for me, r in enumerate(got):
        k = r["keys"].view(keys.dtype)
        for src in range(NS):
            sl = slice(src * cap, (src + 1) * cap)
            mine = np.nonzero(d[src * n_local:(src + 1) * n_local] == me)[0]
            if sort_within_dest:
                order = np.argsort(keys[src * n_local + mine],
                                   kind="stable")
                mine = mine[order]
            kept = mine[:cap]
            dropped += mine.size - kept.size
            n = kept.size
            assert np.array_equal(k[sl][:n], keys[src * n_local + kept])
            assert np.array_equal(r["row"][sl][:n], src * n_local + kept)
            assert r["valid"][sl][:n].all() and not r["valid"][sl][n:].any()
            assert (k[sl][n:] == pad).all() and (r["row"][sl][n:] == -1).all()
    assert dropped > 0
    assert all(r["overflow"] == dropped for r in got)


def test_mesh_rules(pool):
    seen = pool.run("probe_mesh_rules", NS)
    assert all(s["too_many"] == f"requested {NS + 1} devices, have {NS}"
               for s in seen)
    assert [s["block"] for s in seen] == [[4 * r + i for i in range(4)]
                                          for r in range(NS)]
    assert all(s["size"] == NS and s["names"] == ("x",) for s in seen)
    assert all(s["nccl_cpu"].startswith("the process group is NCCL")
               for s in seen)
    assert all(s["too_many_2d"] == f"requested {2 * NS} devices, have {NS}"
               for s in seen)


def test_cuda_mesh_refused_without_a_card():
    from hashjoin3d_tpu_torch.parallel import make_mesh

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh(device="cuda")


ONE_RANK = r"""
import sys
import numpy as np
from hashjoin3d_tpu_torch import parallel
import torch.distributed as dist
bk, pk = (np.frombuffer(bytes.fromhex(h), np.uint32) for h in sys.argv[1:3])
mesh = parallel.make_mesh(device="cpu")   # no group yet: starts one
assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
out = parallel.dist_nested_join(mesh, 64, bk.size, pk.size, 8 * pk.size)(
    parallel.shard_axis(mesh, bk), parallel.shard_axis(mesh, pk))
print(int(out["num_matches"]), int(out["num_cmps"]),
      int(out["num_unnested"]), int(out["overflow"]))
dist.destroy_process_group()
"""


def test_make_mesh_starts_a_one_rank_group():
    """With no process group, ``make_mesh`` starts a 1-rank one (gloo on
    the CPU; NCCL on a card): the 1-rank join is the single-chip engine,
    ``num_cmps`` included (the exchange keeps the global order)."""
    bk, pk = uniform_or_skewed(11, False)
    proc = subprocess.run(
        [sys.executable, "-c", ONE_RANK, bk.tobytes().hex(),
         pk.tobytes().hex()], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    m, c, u, o = map(int, proc.stdout.split())
    res = probe_nested(build_nested(key_column(bk, "cpu"), 64),
                       key_column(pk, "cpu"))
    assert (m, c) == (int(res.num_matches), int(res.num_cmps))
    assert (u, o) == (len(oracle_pairs(bk, pk)), 0)


DIST_OVERHEAD = r"""
import json
from hashjoin3d_tpu_torch.tools.dist_overhead import measure
import torch.distributed as dist
print(json.dumps(measure(12, 0.0, 1, device="cpu")))
dist.destroy_process_group()
"""


def test_dist_overhead_tool_runs_its_four_paths():
    """``tools/dist_overhead.py`` at 2^12 rows a side on the CPU (a check
    of its code path, not a measurement): the four paths agree on the
    result count, which is numpy's."""
    import json

    proc = subprocess.run([sys.executable, "-c", DIST_OVERHEAD],
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    r = json.loads(proc.stdout.splitlines()[-1])
    rng = np.random.default_rng(5)
    bk = rng.integers(0, 1024, 4096, dtype=np.uint32)
    pk = rng.integers(0, 1024, 4096, dtype=np.uint32)
    assert r["results"] == int(np.bincount(bk, minlength=1024)[pk].sum())
    assert set(r["ratio"]) == {"dist default", "dist windowed", "dist fast"}


LAUNCHED = r"""
import numpy as np
import torch.distributed as dist
from hashjoin3d_tpu_torch import parallel
mesh = parallel.make_mesh(device="cpu")   # reads torchrun's environment
rng = np.random.default_rng(1)
bk = rng.integers(0, 50, 64, dtype=np.uint32)
pk = rng.integers(0, 60, 128, dtype=np.uint32)
out = parallel.dist_nested_join(mesh, 8, 64, 128, 4096)(
    parallel.shard_axis(mesh, bk), parallel.shard_axis(mesh, pk))
if dist.get_rank() == 0:
    print(dist.get_world_size(), int(out["num_unnested"]),
          sum(int((bk == k).sum()) for k in pk))
dist.destroy_process_group()
"""


def test_make_mesh_reads_a_launchers_environment(tmp_path):
    """Under ``torchrun`` (2 processes on this host) ``make_mesh`` joins
    the launcher's group instead of starting a 1-rank one."""
    script = tmp_path / "launched.py"
    script.write_text(LAUNCHED)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1])
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(script)], capture_output=True,
        text=True, timeout=180, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    world, got, want = map(int, proc.stdout.split()[-3:])
    assert world == 2 and got == want > 0
