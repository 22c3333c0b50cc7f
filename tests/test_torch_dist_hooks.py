"""The distributed joins' hooks in the port's builds and strands, on one
process, against the JAX package.

Same seeded numpy inputs on both sides, exact equality (integer work: the
tolerance is zero):

* the fused compacted builds (``_build_chaining_fused`` with the
  early-exit index on and off, ``_build_nested_fused``) over an exchange
  receive: blocks whose dead tails carry the all-ones key
  (``drop_pad_key``), global row ids riding the key sort (``rows``),
  u32 and u64 keys, field by field, and through ``convert.py``;
* ``layout.drop_pad_groups`` and ``shrink_group_arrays``,
  ``shrink_chaining`` and ``shrink_nested``;
* ``keydirect_nested_strand_sorted`` and
  ``keydirect_chaining_strand_sorted`` on ``presorted`` streams: sorted
  in blocks with dead all-ones tails under ``mask``, with
  ``srow_values`` and ``lookup_w``, and (nested) a segment-sorted stream
  with its ``segment``: counters bit-equal, pairs equal as multisets.
"""

import numpy as np
import pytest
import torch

from hashjoin3d_tpu.ops import layout as jlayout
from hashjoin3d_tpu.ops.chaining import _build_chaining_fused as jax_cfused
from hashjoin3d_tpu.ops.chaining import shrink_chaining as jax_cshrink
from hashjoin3d_tpu.ops.nested import _build_nested_fused as jax_nfused
from hashjoin3d_tpu.ops.nested import shrink_nested as jax_nshrink
from hashjoin3d_tpu.ops.strands_windowed import (
    keydirect_chaining_strand_sorted as jax_crs,
    keydirect_nested_strand_sorted as jax_nrs)

from hashjoin3d_tpu_torch.convert import (CHAINING_FIELDS, NESTED_FIELDS,
                                          OPTIONAL_FIELDS,
                                          chaining_table_from_numpy,
                                          nested_table_from_numpy)
from hashjoin3d_tpu_torch.ops import layout as tlayout
from hashjoin3d_tpu_torch.ops import strands_windowed as tw
from hashjoin3d_tpu_torch.ops.chaining import (_build_chaining_fused,
                                               shrink_chaining)
from hashjoin3d_tpu_torch.ops.layout import key_column
from hashjoin3d_tpu_torch.ops.nested import _build_nested_fused, shrink_nested
from hashjoin3d_tpu_torch.ops.sort import window_for_chunk

NS, CAP = 4, 1 << 10          # 4 receive blocks of 1024 slots: 2^12 rows
DOM = 1 << 10
GROUP_FIELDS = ("groups.ukey", "groups.group_start", "groups.group_len",
                "groups.group_rows", "groups.first_row", "groups.n_keys")
CHAINING_TABLE = ("bucket_start", "bucket_len", "pos_by_row",
                  "group_min_pos", "group_chain_first", "key_direct",
                  *GROUP_FIELDS)
NESTED_TABLE = ("main_pos_by_group", "bucket_main_len", "key_direct",
                *GROUP_FIELDS)


def field(table, name):
    for part in name.split("."):
        table = getattr(table, part)
    return table


def same(got, want) -> bool:
    if got is None or want is None:
        return got is None and want is None
    want = np.asarray(want)
    if want.dtype in (np.uint32, np.uint64):
        want = want.view(np.int32 if want.dtype == np.uint32 else np.int64)
    return (tuple(got.shape) == want.shape
            and np.array_equal(got.numpy(), want))


def receive(wide: bool, seed: int, sort_blocks: bool = False):
    """An exchange receive of NS blocks of CAP slots: (keys, live mask,
    global rows).  Each block holds 600-1000 live rows, t=4-like keys
    over DOM (u64: the same values shifted past 2^32), then a dead tail
    on the all-ones key with row -1; ``sort_blocks`` orders each block's
    live rows by key (``sort_within_dest``)."""
    rng = np.random.default_rng(seed)
    dt = np.uint64 if wide else np.uint32
    keys = np.full(NS * CAP, np.iinfo(dt).max, dt)
    rows = np.full(NS * CAP, -1, np.int32)
    live = np.zeros(NS * CAP, bool)
    perm = rng.permutation(1 << 16).astype(np.int32)
    for b in range(NS):
        n = int(rng.integers(600, CAP + 1))
        k = rng.integers(0, DOM, n).astype(dt)
        if wide:
            k = (k << dt(33)) | dt(5)
        if sort_blocks:
            k = np.sort(k, kind="stable")
        keys[b * CAP:b * CAP + n] = k
        rows[b * CAP:b * CAP + n] = perm[b * CAP:b * CAP + n]
        live[b * CAP:b * CAP + n] = True
    return keys, live, rows


def t(a):
    a = np.asarray(a)
    if a.dtype == bool:
        return torch.from_numpy(a.copy())
    return key_column(a, "cpu")


def pairs(out):
    prow, brow = np.asarray(out["probe_row"]), np.asarray(out["build_row"])
    hit = prow >= 0
    return sorted(zip(prow[hit].tolist(), brow[hit].tolist()))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("early,cap_kind", [(True, "fit"), (False, "fit"),
                                            (False, "n")])
def test_chaining_fused_drop_pad_and_rows(wide, early, cap_kind):
    """Both branches of phase 2: the cap-sized histogram (no early-exit
    index, 2 cap <= n) and the row sort (the index, or cap = n)."""
    keys, live, rows = receive(wide, 1)
    nk = np.unique(keys[live]).size
    # +1: the sentinel pad group
    cap = (jlayout.group_capacity(nk + 1, keys.size) if cap_kind == "fit"
           else keys.size)
    assert (2 * cap <= keys.size) == (cap_kind == "fit")
    dom = None if wide else DOM
    want = jax_cfused(keys, cap, 97, False, dom, early, "murmur", True,
                      rows)
    got = _build_chaining_fused(t(keys), cap, 97, False, dom, early,
                                "murmur", drop_pad_key=True, rows=t(rows))
    for f in CHAINING_TABLE:
        assert same(field(got, f), field(want, f)), f
    assert int(got.groups.n_keys) == nk
    assert int(got.bucket_len.sum()) == int(live.sum())


@pytest.mark.parametrize("wide", [False, True])
def test_nested_fused_drop_pad_and_rows(wide):
    keys, live, rows = receive(wide, 2)
    nk = np.unique(keys[live]).size
    cap = jlayout.group_capacity(nk + 1, keys.size)
    dom = None if wide else DOM
    want = jax_nfused(keys, cap, 61, False, dom, "murmur", True, rows)
    got = _build_nested_fused(t(keys), cap, 61, False, dom, "murmur",
                              drop_pad_key=True, rows=t(rows))
    for f in NESTED_TABLE:
        assert same(field(got, f), field(want, f)), f
    assert int(got.groups.n_keys) == nk
    # the global ids are what group_rows emits
    live_rows = got.groups.group_rows[:int(live.sum())]
    assert sorted(live_rows.tolist()) == sorted(rows[live].tolist())


def test_convert_carries_global_row_tables():
    """JAX tables whose group_rows / group_chain_first hold global ids
    cross ``convert.py`` field for field."""
    keys, _, rows = receive(False, 3)
    cap = jlayout.group_capacity(DOM + 1, keys.size)
    jc = jax_cfused(keys, cap, 97, False, DOM, True, "murmur", True, rows)
    pc = chaining_table_from_numpy(
        {f: np.asarray(field(jc, f)) for f in CHAINING_FIELDS
         + OPTIONAL_FIELDS}, num_buckets=97, hashfun="murmur", device="cpu")
    jn = jax_nfused(keys, cap, 61, False, DOM, "murmur", True, rows)
    pn = nested_table_from_numpy(
        {f: np.asarray(field(jn, f)) for f in NESTED_FIELDS},
        num_buckets=61, hashfun="murmur", device="cpu")
    gc = _build_chaining_fused(t(keys), cap, 97, False, DOM, True,
                               drop_pad_key=True, rows=t(rows))
    gn = _build_nested_fused(t(keys), cap, 61, False, DOM,
                             drop_pad_key=True, rows=t(rows))
    for f in CHAINING_TABLE:
        assert torch.equal(field(pc, f), field(gc, f)), f
    for f in NESTED_TABLE:
        assert torch.equal(field(pn, f), field(gn, f)), f


@pytest.mark.parametrize("wide", [False, True])
def test_drop_pad_groups_and_shrink_group_arrays(wide):
    keys, live, _ = receive(wide, 4)
    n = keys.size
    jg = jlayout.compact_group_index(keys, *jlayout.sort_with_rows(keys)[:2],
                                     n)
    skey, srow, _ = tlayout.sort_with_rows(t(keys))
    pg = tlayout.compact_group_index(t(keys), skey, srow, n)
    want, got = jlayout.drop_pad_groups(jg), tlayout.drop_pad_groups(pg)
    for f in ("ukey", "group_start", "group_len", "first_row", "n_keys"):
        assert same(getattr(got, f), getattr(want, f)), f
    assert int(got.n_keys) == np.unique(keys[live]).size
    cap = jlayout.group_capacity(int(got.n_keys), n)
    arrays = (got.ukey, got.group_len)
    sliced = tlayout.shrink_group_arrays(arrays, cap)
    for a, b in zip(sliced, jlayout.shrink_group_arrays(
            (want.ukey, want.group_len), cap)):
        assert same(a, b)
    assert all(a.shape == (cap,) for a in sliced)


@pytest.mark.parametrize("kind", ["chaining", "nested"])
def test_shrink_tables(kind):
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 300, 1 << 12).astype(np.uint32)
    nk = np.unique(keys).size
    cap = jlayout.group_capacity(nk, keys.size)
    n = keys.size
    if kind == "chaining":
        want = jax_cshrink(jax_cfused(keys, n, 64, False, 300), cap)
        got = shrink_chaining(_build_chaining_fused(t(keys), n, 64, False,
                                                    300), cap)
        names = CHAINING_TABLE
    else:
        want = jax_nshrink(jax_nfused(keys, n, 64, False, 300), cap)
        got = shrink_nested(_build_nested_fused(t(keys), n, 64, False, 300),
                            cap)
        names = NESTED_TABLE
    for f in names:
        assert same(field(got, f), field(want, f)), f
    assert got.groups.ukey.shape == (cap,)


def _jax_tables(kind, seed, unique=False):
    """A compacted key_direct table over a build receive (global rows,
    dead tails), built by the JAX package and carried across, and the
    port's own fused build of the same receive."""
    keys, _, rows = receive(False, seed)
    if unique:  # at most one live row a key
        keys = keys.copy()
        live = keys != np.uint32(0xFFFFFFFF)
        keys[live] = np.random.default_rng(seed).permutation(
            4 * DOM)[:int(live.sum())].astype(np.uint32)
    dom = 4 * DOM
    cap = jlayout.group_capacity(dom + 1, keys.size)
    if kind == "chaining":
        jt = jax_cfused(keys, cap, 97, False, dom, unique, "murmur", True,
                        rows)
        pt = chaining_table_from_numpy(
            {f: np.asarray(field(jt, f)) for f in CHAINING_FIELDS
             + OPTIONAL_FIELDS}, num_buckets=97, hashfun="murmur",
            device="cpu")
        own = _build_chaining_fused(t(keys), cap, 97, False, dom, unique,
                                    drop_pad_key=True, rows=t(rows))
    else:
        jt = jax_nfused(keys, cap, 61, False, dom, "murmur", True, rows)
        pt = nested_table_from_numpy(
            {f: np.asarray(field(jt, f)) for f in NESTED_FIELDS},
            num_buckets=61, hashfun="murmur", device="cpu")
        own = _build_nested_fused(t(keys), cap, 61, False, dom,
                                  drop_pad_key=True, rows=t(rows))
    return jt, pt, own, dom


def _presorted_probe(seed):
    """A probe receive sorted within its blocks (dead all-ones tails,
    live keys over [0, 2 DOM + DOM / 4): some miss the domain), its mask
    and global probe ids."""
    keys, live, rows = receive(False, seed, sort_blocks=True)
    k = keys.astype(np.int64)
    k[live] = (k[live] * 2 + (k[live] % 3 == 0) * DOM // 4)
    keys = k.astype(np.uint32)
    for b in range(NS):  # keep each block ascending
        blk = slice(b * CAP, (b + 1) * CAP)
        n = int(live[blk].sum())
        keys[b * CAP:b * CAP + n] = np.sort(keys[b * CAP:b * CAP + n])
    return keys, live, rows


@pytest.mark.parametrize("table", ["jax", "own"])
def test_nested_strand_presorted_blocks(table):
    jt, pt, own, dom = _jax_tables("nested", 6)
    pk, live, prow = _presorted_probe(7)
    W = window_for_chunk(CAP, dom)
    out = 1 << 15
    want = jax_nrs(jt, pk, out, mask=live, presorted=True, srow_values=prow,
                   lookup_w=W)
    got = tw.keydirect_nested_strand_sorted(
        pt if table == "jax" else own, t(pk), out, mask=t(live),
        presorted=True, srow_values=t(prow), lookup_w=W)
    for k in ("c_htProbe", "c_htProbeCmp", "c_unnest", "total"):
        assert int(got[k]) == int(want[k]), k
    assert 0 < int(got["c_unnest"]) <= out
    assert pairs(got) == pairs(want)
    # global ids on both sides
    assert set(p for p, _ in pairs(got)) <= set(prow[live].tolist())
    if int(want["route_worst"]) == 0:
        assert got["route_worst"] == 0


def test_nested_strand_presorted_segments():
    """A segment-sorted stream with no dead rows (a ring chunk sorted at
    home): ``segment`` widens the emission window as the local sort's
    segment does."""
    jt, pt, _, dom = _jax_tables("nested", 8)
    rng = np.random.default_rng(9)
    seg = 1 << 10
    pk = rng.integers(0, dom, NS * seg).astype(np.uint32)
    pk = np.sort(pk.reshape(NS, seg), axis=1).reshape(-1)
    rows = rng.permutation(1 << 14)[:pk.size].astype(np.int32)
    W = window_for_chunk(seg, dom)
    out = 1 << 15
    want = jax_nrs(jt, pk, out, presorted=True, srow_values=rows,
                   lookup_w=W, segment=seg)
    got = tw.keydirect_nested_strand_sorted(
        pt, t(pk), out, presorted=True, srow_values=t(rows), lookup_w=W,
        segment=seg)
    for k in ("c_htProbe", "c_htProbeCmp", "c_unnest"):
        assert int(got[k]) == int(want[k]), k
    assert pairs(got) == pairs(want)


@pytest.mark.parametrize("unique", [False, True])
@pytest.mark.parametrize("table", ["jax", "own"])
def test_chaining_strand_presorted_blocks(unique, table):
    jt, pt, own, dom = _jax_tables("chaining", 10, unique=unique)
    pk, live, prow = _presorted_probe(11)
    W = window_for_chunk(CAP, dom)
    out = 1 << 15
    want = jax_crs(jt, pk, out, unique=unique, mask=live, presorted=True,
                   srow_values=prow, lookup_w=W)
    got = tw.keydirect_chaining_strand_sorted(
        pt if table == "jax" else own, t(pk), out, unique=unique,
        mask=t(live), presorted=True, srow_values=t(prow), lookup_w=W)
    for k in ("c_htProbe", "c_htProbeCmp", "total"):
        assert int(got[k]) == int(want[k]), k
    assert 0 < int(got["total"]) <= out
    assert pairs(got) == pairs(want)


def test_presorted_contract_errors():
    _, pt, _, _ = _jax_tables("nested", 12)
    pk = t(np.arange(16, dtype=np.uint32))
    with pytest.raises(ValueError, match="presorted"):
        tw.keydirect_nested_strand_sorted(pt, pk, 64,
                                          srow_values=t(np.arange(16)))
    with pytest.raises(ValueError, match="exclude"):
        tw.keydirect_nested_strand_sorted(pt, pk, 64, presorted=True,
                                          probes_iota=True)
