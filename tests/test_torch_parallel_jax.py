"""The port's distributed joins against the JAX package's.

One case an entry point (and a route where the entry point has several):
the same seeded numpy columns go through ``hashjoin3d_tpu.parallel`` on
``make_mesh(4)`` (``make_mesh_2d(2, 2)`` for the hierarchy) of the
virtual CPU devices and through ``hashjoin3d_tpu_torch.parallel`` on 4
gloo ranks (``tests/torch_ranks.py``; no ``jax`` in the ranks).  Every
counter, ``num_cmps`` and ``overflow`` included, is bit-equal, and each
shard's pairs (triples, aggregates) are equal as multisets, shard by
shard: the exchange's arrival order and the global row ids are the JAX
package's.  The exchange's receive itself is held slot for slot.
"""

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from hashjoin3d_tpu import parallel as jpar
from hashjoin3d_tpu.parallel.shuffle import partition_exchange as jax_xchg

from torch_ranks import RankPool, gathered

NS = 4
ROW_COLS = {"pairs": ("probe_row", "build_row"),
            "triples": ("r_row", "s_row", "t_row")}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(NS, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield p
    p.close()


@pytest.fixture(scope="module")
def meshes():
    assert jax.device_count() >= NS
    return jpar.make_mesh(NS), jpar.make_mesh_2d(2, 2)


def jax_step(meshes, entry, columns, mesh_kind, kwargs):
    mesh = meshes[0] if mesh_kind == "flat" else meshes[1]
    sh = (jpar.shard_axis(mesh) if mesh_kind == "flat"
          else NamedSharding(mesh, P(("host", "chip"))))
    out = getattr(jpar, entry)(mesh, **kwargs)(
        *(jax.device_put(c, sh) for c in columns))
    return {k: np.asarray(v) for k, v in out.items()}


def per_shard(rows: dict, cols) -> list:
    """Each shard's valid rows as a sorted list (a multiset)."""
    v = np.split(np.asarray(rows["out_valid"]), NS)
    parts = [np.split(np.asarray(rows[c]).astype(np.int64), NS)
             for c in cols]
    return [sorted(zip(*(p[s][v[s]].tolist() for p in parts)))
            for s in range(NS)]


def groups_per_shard(rows: dict) -> list:
    out = []
    for k, n, s in zip(*(np.split(np.asarray(rows[c]), NS) for c in
                         ("group_keys", "group_count", "group_sum"))):
        live = n > 0
        out.append(sorted(zip(k[live].astype(np.int64).tolist(),
                              n[live].tolist(), s[live].tolist())))
    return out


def compare(pool, meshes, entry, columns, mesh_kind="flat", rows="pairs",
            port_kwargs=None, **kwargs):
    want = jax_step(meshes, entry, columns, mesh_kind, kwargs)
    got_c, got_rows = gathered(pool.run(
        "run_step", entry, {**kwargs, **(port_kwargs or {})},
        list(columns), mesh_kind))
    assert set(got_c) | set(got_rows) == set(want)
    for k, v in got_c.items():
        assert v == int(want[k]), k
    if rows == "groups":
        # a u64 group key rides the int64 carrier: compare its bits
        want["group_keys"] = np.asarray(want["group_keys"]).view(
            np.int64 if want["group_keys"].dtype == np.uint64 else
            want["group_keys"].dtype)
        assert groups_per_shard(got_rows) == groups_per_shard(want)
    else:
        assert per_shard(got_rows, ROW_COLS[rows]) == per_shard(
            want, ROW_COLS[rows])
    return got_c


def columns(seed, n_b=1024, n_p=2048, hi_b=500, hi_p=600, skewed=False):
    rng = np.random.default_rng(seed)
    if skewed:
        bk = np.minimum(rng.zipf(1.2, n_b), 300).astype(np.uint32)
    else:
        bk = rng.integers(0, hi_b, n_b, dtype=np.uint32)
    return bk, rng.integers(0, hi_p, n_p, dtype=np.uint32)


def u64_columns():
    rng = np.random.default_rng(67)
    base = (rng.choice(1 << 20, 96, replace=False).astype(np.uint64)
            << np.uint64(40)) | np.uint64(0xABCDEF)
    bk = np.repeat(base[:64], rng.integers(1, 6, 64)).astype(np.uint64)
    rng.shuffle(bk)
    return bk[:bk.size - bk.size % NS], rng.choice(base, 256).astype(
        np.uint64)


JOIN = dict(num_buckets_per_shard=64, build_capacity=1024,
            probe_capacity=2048, out_capacity=1 << 15)


@pytest.mark.parametrize("route", ["default", "fast", "merged", "overflow"])
def test_dist_nested_join(pool, meshes, route):
    bk, pk = columns(97, skewed=route == "fast")
    kw = dict(JOIN)
    if route == "fast":
        kw.update(key_domain=600, n_keys=600)
    elif route == "merged":
        bk, pk = u64_columns()
        kw.update(num_buckets_per_shard=16, build_capacity=bk.size,
                  probe_capacity=256, out_capacity=4096)
    elif route == "overflow":
        kw.update(build_capacity=48, probe_capacity=100)
    c = compare(pool, meshes, "dist_nested_join", (bk, pk), **kw)
    assert (c["overflow"] > 0) == (route == "overflow")


@pytest.mark.parametrize("route,unique", [("default", False),
                                          ("fast", True), ("merged", False),
                                          ("windowed", False)])
def test_dist_chaining_join(pool, meshes, route, unique):
    rng = np.random.default_rng(103)
    if unique:
        bk = rng.permutation(2048)[:1024].astype(np.uint32)
        pk = rng.integers(0, 2048, 2048, dtype=np.uint32)
    else:
        bk, pk = columns(103)
    kw = dict(JOIN, unique=unique)
    if route == "fast":
        kw.update(key_domain=2048, n_keys=2048)
    elif route == "windowed":
        kw.update(key_domain=600)
    elif route == "merged":
        bk, pk = u64_columns()
        kw.update(num_buckets_per_shard=16, build_capacity=bk.size,
                  probe_capacity=256, out_capacity=4096)
    c = compare(pool, meshes, "dist_chaining_join", (bk, pk), **kw)
    assert c["overflow"] == 0


def test_dist_nested_join_chunked(pool, meshes):
    bk, pk = columns(73, n_p=4096)
    compare(pool, meshes, "dist_nested_join_chunked", (bk, pk),
            num_buckets_per_shard=64, build_capacity=1024,
            probe_capacity=1024, out_capacity=1 << 16, n_chunks=4,
            step_out_capacity=1 << 14)


@pytest.mark.parametrize("route", ["default", "fast"])
def test_dist_ring_nested_join(pool, meshes, route):
    bk, pk = columns(107)
    kw = dict(num_buckets_per_shard=64, build_capacity=1024,
              out_capacity=1 << 15, step_out_capacity=1 << 14)
    if route == "fast":
        kw.update(key_domain=600, n_keys=600)
    compare(pool, meshes, "dist_ring_nested_join", (bk, pk), **kw)


def test_ring_step_truncation(pool, meshes):
    bk = np.full(16, 5, np.uint32)
    c = compare(pool, meshes, "dist_ring_nested_join", (bk, bk.copy()),
                num_buckets_per_shard=8, build_capacity=16, out_capacity=256,
                step_out_capacity=8)
    assert c["overflow"] > 0


@pytest.mark.parametrize("route", ["default", "fast"])
def test_dist_nested_join_2d(pool, meshes, route):
    bk, pk = columns(109)
    kw = dict(JOIN)
    if route == "fast":
        kw.update(key_domain=600, n_keys=600)
    compare(pool, meshes, "dist_nested_join_2d", (bk, pk), "2d", **kw)


@pytest.mark.parametrize("nested", [True, False])
def test_dist_broadcast_join(pool, meshes, nested):
    bk, pk = columns(21, n_b=256, n_p=1024, hi_b=100, hi_p=120)
    compare(pool, meshes, "dist_broadcast_join", (bk, pk), num_buckets=64,
            out_capacity=1 << 14, nested=nested)


def test_dist_hybrid_nested_join(pool, meshes):
    rng = np.random.default_rng(41)
    bk = np.concatenate([np.full(8, 123, np.uint32),
                         rng.integers(0, 400, 1016, dtype=np.uint32)])
    rng.shuffle(bk)
    pk = np.concatenate([np.full(2048, 123, np.uint32),
                         rng.integers(0, 500, 2048, dtype=np.uint32)])
    rng.shuffle(pk)
    hot = jpar.detect_skew(pk, NS)["hot_keys"].tolist()
    compare(pool, meshes, "dist_hybrid_nested_join", (bk, pk),
            hot_keys=hot, num_buckets_per_shard=64, build_capacity=1024,
            probe_capacity=384, hot_build_capacity=64, out_capacity=1 << 15)


@pytest.mark.parametrize("u64", [False, True])
def test_dist_filter_join_aggregate(pool, meshes, u64):
    rng = np.random.default_rng(33)
    bk = rng.integers(0, 120, 512, dtype=np.uint32)
    pk = rng.integers(0, 150, 1024, dtype=np.uint32)
    if u64:
        bk = (bk.astype(np.uint64) << np.uint64(35)) | np.uint64(7)
        pk = (pk.astype(np.uint64) << np.uint64(35)) | np.uint64(7)
    bv = rng.integers(0, 50, 512, dtype=np.int32)
    pp = rng.integers(0, 100, 1024, dtype=np.int32)
    c = compare(pool, meshes, "dist_filter_join_aggregate", (bk, bv, pk, pp),
                rows="groups", port_kwargs=dict(predicate="below_60"),
                num_buckets_per_shard=32, build_capacity=512,
                probe_capacity=1024, out_capacity=8192,
                predicate=lambda p: p < 60)
    assert c["n_groups"] > 0


def test_dist_deferred_two_join(pool, meshes):
    from hashjoin3d_tpu.utils import exp4_data

    sa, ta = exp4_data(8, 2, 2, 3, 2)
    rk = np.arange(256, dtype=np.uint32)
    c = compare(pool, meshes, "dist_deferred_two_join", (rk, sa, ta),
                rows="triples", num_buckets_per_shard=64,
                fk_capacity=sa.size, r_capacity=rk.size, out1_capacity=1024,
                out2_capacity=1024)
    assert c["c_top"] > 0


@pytest.mark.parametrize("u64", [False, True])
@pytest.mark.parametrize("sort_within_dest", [False, True])
def test_partition_exchange_receive(pool, meshes, u64, sort_within_dest):
    """The receive slot for slot: keys, global rows, validity, and the
    overflow of a capacity that drops rows."""
    from jax import lax, shard_map

    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 32, 1024, dtype=np.uint64)
    keys = ((keys << np.uint64(29)) | np.uint64(1) if u64
            else keys.astype(np.uint32))
    cap = 70
    mesh = meshes[0]

    def body(k):
        n = k.shape[0]
        rows = lax.axis_index("x").astype(np.int32) * n + jax.numpy.arange(
            n, dtype=np.int32)
        kr, pay, valid, ovf = jax_xchg("x", k, {"row": rows}, NS, cap,
                                       sort_within_dest=sort_within_dest)
        return kr, pay["row"], valid, ovf

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("x"),),
                           out_specs=(P("x"), P("x"), P("x"), P())))
    kr, rr, vr, ovf = (np.asarray(a) for a in
                       fn(jax.device_put(keys, jpar.shard_axis(mesh))))
    got = pool.run("exchange", keys, cap, sort_within_dest)
    for s, r in enumerate(got):
        sl = slice(s * NS * cap, (s + 1) * NS * cap)
        assert np.array_equal(r["keys"].view(keys.dtype), kr[sl])
        assert np.array_equal(r["row"], rr[sl])
        assert np.array_equal(r["valid"], vr[sl])
        assert r["overflow"] == int(ovf) > 0
