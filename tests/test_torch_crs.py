"""The port's compacted chaining table, plan Crs and the *Sel plans on the
CPU against the JAX package.

Same seeded numpy inputs on both sides, exact equality (integer work: the
tolerance is zero):

* ``_build_chaining_fused`` with the early-exit index on and off, on both
  branches of phase 2 (the cap-sized bucket histogram where ``2 * cap <=
  n``, the row sort elsewhere), field by field, on uniform, t=4-like,
  zipf-like and sparse keys and on a column holding keys >= 2^31; the
  one-read build (``n_keys`` None), its statistics and memory split;
* ``keydirect_chaining_strand_sorted`` on its permutation, sorted (K1's
  packed route and the wide-key route) and mask routes, with and without
  ``unique``, over a JAX-built table carried across by ``convert.py``:
  counters bit-equal, result pairs equal as multisets, the route equal;
* the ``mask`` path of ``direct_probe_strand_sorted`` (CsrSel) and of
  ``keydirect_nested_strand_sorted`` (NrsSel), with a live 0xFFFFFFFF
  key, keys >= 2^31 and dead rows;
* the *Sel predicate on keys >= 2^31;
* ``Experiment1(device="cpu")``: the Crs rows of both golden CSVs, and the
  CsrSel, CrsSel and NrsSel rows equal to the JAX harness's.
"""

import csv
import io

import numpy as np
import pytest
import torch

from hashjoin3d_tpu.models.exp1 import Experiment1 as JaxExperiment1
from hashjoin3d_tpu.ops import stats as jstats
from hashjoin3d_tpu.ops.chaining import _build_chaining_fused as jax_fused
from hashjoin3d_tpu.ops.chaining import build_chaining_host as jax_chaining
from hashjoin3d_tpu.ops.layout import group_capacity
from hashjoin3d_tpu.ops.nested import build_nested_host as jax_nested
from hashjoin3d_tpu.ops.strands_windowed import (
    direct_probe_strand_sorted as jax_direct,
    keydirect_chaining_strand_sorted as jax_crs,
    keydirect_nested_strand_sorted as jax_nrs)

from hashjoin3d_tpu_torch.convert import (CHAINING_FIELDS, OPTIONAL_FIELDS,
                                          chaining_table_from_numpy)
from hashjoin3d_tpu_torch.models.exp1 import Experiment1, sel_mask
from hashjoin3d_tpu_torch.ops import stats as tstats
from hashjoin3d_tpu_torch.ops import strands_windowed as tw
from hashjoin3d_tpu_torch.ops.chaining import (_build_chaining_fused,
                                               build_chaining_host)
from hashjoin3d_tpu_torch.ops.layout import from_numpy_u32
from hashjoin3d_tpu_torch.ops.nested import build_nested_host

from test_experiments import GOLDEN, _VALUE_COLS

N = 1 << 13
TABLE_FIELDS = ("bucket_start", "bucket_len", "pos_by_row", "group_min_pos",
                "group_chain_first", "key_direct", "groups.ukey",
                "groups.group_start", "groups.group_len", "groups.group_rows",
                "groups.first_row", "groups.n_keys")
GOLDENS = [
    ("e1_R6_S8_uni_t0.csv", dict(log2_card_r=6, log2_card_s=8, skew=False,
                                 t=0, b=1)),
    ("e1_R7_S9_zipf_t2_b2.csv", dict(log2_card_r=7, log2_card_s=9, skew=True,
                                     t=2, b=2)),
]
SEL_PLANS = ("CsrSel", "CrsSel", "NrsSel")


def t32(a):
    return from_numpy_u32(np.asarray(a), "cpu")


def field(table, name):
    for part in name.split("."):
        table = getattr(table, part)
    return table


def same(got, want) -> bool:
    if got is None or want is None:
        return got is None and want is None
    want = np.asarray(want)
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    return tuple(got.shape) == want.shape and np.array_equal(got.numpy(),
                                                             want)


def pairs(out):
    prow, brow = np.asarray(out["probe_row"]), np.asarray(out["build_row"])
    hit = prow >= 0
    return sorted(zip(prow[hit].tolist(), brow[hit].tolist()))


def key_column(kind: str):
    """(2^13 build keys, their key domain): uniform over 2^11 (4 rows a
    key), t=4-like over 2^9 (16 rows a key), zipf-like over 2^11 (a hot
    group), sparse over 2^14 (more distinct keys than n / 2: the row-sort
    branch even without the early-exit index) and uniform with every
    seventh key past 2^31 (out of the domain)."""
    rng = np.random.default_rng({"uniform": 0, "t4": 1, "zipf": 2,
                                 "sparse": 3, "wide": 4}[kind])
    if kind in ("uniform", "wide"):
        dom = 1 << 11
        keys = rng.integers(0, dom, N)
        if kind == "wide":
            keys[::7] = 2**32 - 1 - rng.integers(0, 2**31, keys[::7].size)
    elif kind == "t4":
        dom = 1 << 9
        keys = rng.integers(0, dom, N)
    elif kind == "zipf":
        dom = 1 << 11
        keys = (rng.zipf(1.3, N) - 1) % dom
    else:
        dom = 1 << 14
        keys = rng.integers(0, dom, N)
    return keys.astype(np.uint32), dom


@pytest.mark.parametrize("ee", [True, False])
@pytest.mark.parametrize("kind", ["uniform", "t4", "zipf", "sparse", "wide"])
def test_fused_build_matches_jax(kind, ee):
    keys, dom = key_column(kind)
    nk = np.unique(keys).size
    cap = group_capacity(nk, N)
    assert (2 * cap <= N) == (kind != "sparse")
    want = jax_fused(keys, cap, nk, False, dom, ee)
    got = _build_chaining_fused(t32(keys), cap, nk, False, dom, ee)
    for f in TABLE_FIELDS:
        assert same(field(got, f), field(want, f)), f
    assert (got.pos_by_row.numel() > 0) == ee
    assert got.direct is None


@pytest.mark.parametrize("kind", ["zipf", "wide"])
def test_one_read_build_stats_and_memory(kind):
    """``n_keys`` None reads the distinct count back once; the table, its
    ht_* CSV fields and its memory split equal the JAX table's."""
    keys, dom = key_column(kind)
    nk = np.unique(keys).size
    want = jax_chaining(keys, nk, key_domain=dom)
    got = build_chaining_host(t32(keys), nk, key_domain=dom)
    for f in TABLE_FIELDS:
        assert same(field(got, f), field(want, f)), f
    assert (tstats.chaining_statistics(got).to_csv_fields()
            == jstats.chaining_statistics(want).to_csv_fields())
    mem = got.memory_consumption()
    assert mem["dir"] == want.memory_consumption()["dir"]
    assert mem["total"] == mem["dir"] + mem["chains"] > 0


def _carried(jt):
    fields = {f: np.asarray(field(jt, f))
              for f in CHAINING_FIELDS + OPTIONAL_FIELDS}
    return chaining_table_from_numpy(fields, num_buckets=jt.num_buckets,
                                     hashfun=jt.hashfun, device="cpu")


def _probe_column(route: str, dom: int, rng):
    """(probe keys, mask or None, strand arguments) of one route."""
    P = 1 << 13
    if route == "permutation":
        return rng.permutation(P).astype(np.uint32), None, dict(
            probes_permutation=True)
    if route in ("sorted_packed", "sorted_wide"):
        hi = dom if route == "sorted_packed" else dom + dom // 8
        return rng.integers(0, hi, P).astype(np.uint32), None, {}
    pk = rng.integers(0, dom + dom // 8, P).astype(np.uint32)
    pk[:32] = 2**32 - 1 - rng.integers(0, 2**31, 32)  # keys >= 2^31
    pk[40:48] = 0xFFFFFFFF
    mask = rng.random(P) < 0.6
    mask[:48] = True  # live, among them live 0xFFFFFFFF keys
    return pk, mask, {}


@pytest.mark.parametrize("unique", [False, True])
@pytest.mark.parametrize("route", ["permutation", "sorted_packed",
                                   "sorted_wide", "mask"])
def test_chaining_strand_matches_jax(route, unique, monkeypatch):
    keys, dom = key_column("t4")
    nk = np.unique(keys).size
    jt = jax_chaining(keys, nk, n_keys=nk, key_domain=dom,
                      early_exit_index=unique)
    pt = _carried(jt)
    rng = np.random.default_rng(10)
    pk, mask, kw = _probe_column(route, dom, rng)
    out_size = 1 << 18  # room for every pair: none cut
    calls = []
    real = tw.bitonic_sort_packed_segmented
    monkeypatch.setattr(tw, "bitonic_sort_packed_segmented",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want = jax_crs(jt, pk, out_size, unique=unique, mask=mask, **kw)
    got = tw.keydirect_chaining_strand_sorted(
        pt, t32(pk), out_size, unique=unique,
        mask=None if mask is None else torch.from_numpy(mask), **kw)
    for k in ("c_htProbe", "c_htProbeCmp", "total"):
        assert int(got[k]) == int(want[k]), k
    assert int(got["total"]) <= out_size
    assert pairs(got) == pairs(want)
    if int(want["route_worst"]) == 0:
        assert got["route_worst"] == 0
    assert calls == ([1] if route == "sorted_packed" else [])


def test_chaining_strand_needs_the_early_exit_index():
    keys, dom = key_column("t4")
    nk = np.unique(keys).size
    pt = build_chaining_host(t32(keys), nk, n_keys=nk, key_domain=dom,
                             early_exit_index=False)
    with pytest.raises(ValueError, match="early_exit_index"):
        tw.keydirect_chaining_strand_sorted(pt, t32(keys[:1024]), 4096,
                                            unique=True)


@pytest.mark.parametrize("plan", ["CsrSel", "NrsSel"])
def test_mask_path_matches_jax(plan):
    """CsrSel's dense-direct strand and NrsSel's nested strand under a
    mask: dead rows probe nothing, a live 0xFFFFFFFF key and live keys
    >= 2^31 walk their chains as misses."""
    rng = np.random.default_rng(11)
    if plan == "CsrSel":
        n = 4096
        bk = rng.permutation(n).astype(np.uint32)
        jt = jax_chaining(bk, 1500, dense_direct=True, n_keys=n)
        pt = build_chaining_host(t32(bk), 1500, dense_direct=True, n_keys=n)
        dom = n
    else:
        bk, dom = key_column("zipf")
        nk = np.unique(bk).size
        jt = jax_nested(bk, nk, n_keys=nk, key_domain=dom)
        pt = build_nested_host(t32(bk), nk, n_keys=nk, key_domain=dom)
    pk, mask, _ = _probe_column("mask", dom, rng)
    tmask = torch.from_numpy(mask)
    if plan == "CsrSel":
        want = jax_direct(jt, pk, unique=True, mask=mask)
        got = tw.direct_probe_strand_sorted(pt, t32(pk), unique=True,
                                            mask=tmask)
        counters = ("c_htProbe", "c_htProbeCmp", "total")
    else:
        out_size = 1 << 16
        want = jax_nrs(jt, pk, out_size, mask=mask)
        got = tw.keydirect_nested_strand_sorted(pt, t32(pk), out_size,
                                                mask=tmask)
        counters = ("c_htProbe", "c_htProbeCmp", "c_unnest", "total")
    for k in counters:
        assert int(got[k]) == int(want[k]), k
    assert pairs(got) == pairs(want)
    assert got["route_worst"] == int(want["route_worst"])
    if plan == "CsrSel":  # the dead rows' walks stay out of the count
        all_live = tw.direct_probe_strand_sorted(
            pt, t32(pk), unique=True, mask=torch.ones_like(tmask))
        assert int(all_live["c_htProbeCmp"]) > int(got["c_htProbeCmp"])


def test_sel_predicate_is_unsigned():
    keys = t32(np.array([0, 5, 2**31 - 1, 2**31, 2**32 - 1, 9], np.uint32))
    assert sel_mask(keys, 8).tolist() == [True, True, False, False, False,
                                          False]


def _rows(text):
    rows = list(csv.reader(io.StringIO(text), delimiter=";"))
    return rows[0], {r[9]: r for r in rows[1:]}


@pytest.mark.parametrize("golden,params", GOLDENS)
def test_crs_rows_match_reference(golden, params):
    buf = io.StringIO()
    exp = Experiment1(**params, measure_file=buf, min_runtime_s=0.0,
                      min_repeat=1, trace=False, plans=("Crs",),
                      device="cpu")
    exp.init()
    exp.run()
    ref_hdr, ref = _rows((GOLDEN / golden).read_text())
    hdr, got = _rows(buf.getvalue())
    assert hdr == ref_hdr and list(got) == ["Crs"]
    cols = _VALUE_COLS(hdr)
    assert [got["Crs"][i] for i in cols] == [ref["Crs"][i] for i in cols]
    assert exp.results["Crs"][1]["route_worst"] == 0


@pytest.fixture(scope="module")
def jax_sel_rows():
    params = GOLDENS[1][1]
    buf = io.StringIO()
    exp = JaxExperiment1(**params, measure_file=buf, min_runtime_s=0.0,
                         min_repeat=1, trace=False, backend="device",
                         plans=SEL_PLANS)
    exp.init()
    exp.run()
    return params, _rows(buf.getvalue())


@pytest.mark.parametrize("plan", SEL_PLANS)
def test_sel_rows_match_jax(plan, jax_sel_rows):
    params, (ref_hdr, ref) = jax_sel_rows
    buf = io.StringIO()
    exp = Experiment1(**params, measure_file=buf, min_runtime_s=0.0,
                      min_repeat=1, trace=False, plans=(plan,),
                      device="cpu")
    exp.init()
    exp.run()
    hdr, got = _rows(buf.getvalue())
    assert hdr == ref_hdr and list(got) == [plan]
    cols = _VALUE_COLS(hdr)
    assert [got[plan][i] for i in cols] == [ref[plan][i] for i in cols]
    assert got[plan][hdr.index("c_selProbe")] != "NA"
    assert exp.results[plan][1]["route_worst"] == 0
