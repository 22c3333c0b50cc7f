"""The port's algebra, its example and the harnesses' clarity strands on the
CPU against the JAX package.

* the six golden tests of ``tests/test_algebra.py`` on the port
  (``device="cpu"``): counts, ``num_cmps``, result rows, ``print_strand``,
  ``compile_strand`` with its capacity hints and its overflow raise;
* each example plan against the JAX algebra: counts, ``num_cmps``, row
  multisets, ``print_strand``'s operator names, counts and runs;
* a residual predicate on both join kinds, interpreted and fused;
* a u32 predicate and printed rows with values at and above 2^31;
* exp-1's clarity strands against the JAX package's and the windowed
  strands on a JAX-built table; Csr, CsrUU and Nsr with R.k declared not
  dense (the clarity strands): rows equal to both golden CSVs;
* exp-4's clarity strands (Ndu, Chj, Nnu) against the JAX package's on
  the shapes of ``tests/test_experiments.py``, with numpy oracle triples.

Integer work throughout: the tolerance is zero.
"""

import csv
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hashjoin3d_tpu.models import algebra as jalg
from hashjoin3d_tpu.models import algebra_example as jex
from hashjoin3d_tpu.models import exp1 as jexp1
from hashjoin3d_tpu.models import exp4 as jexp4
from hashjoin3d_tpu.ops import build_chaining as jax_chaining
from hashjoin3d_tpu.ops import build_nested as jax_nested
from hashjoin3d_tpu.ops.chaining import \
    build_chaining_host as jax_chaining_host
from hashjoin3d_tpu.ops.nested import build_nested_host as jax_nested_host
from hashjoin3d_tpu.utils import exp4_data

from hashjoin3d_tpu_torch.convert import (CHAINING_FIELDS, NESTED_FIELDS,
                                          chaining_table_from_numpy,
                                          nested_table_from_numpy)
from hashjoin3d_tpu_torch.models import algebra as talg
from hashjoin3d_tpu_torch.models import algebra_example as ex
from hashjoin3d_tpu_torch.models import exp1 as texp1
from hashjoin3d_tpu_torch.models import exp4 as texp4
from hashjoin3d_tpu_torch.models.exp1 import Experiment1
from hashjoin3d_tpu_torch.models.exp4 import Experiment4
from hashjoin3d_tpu_torch.ops.chaining import build_chaining
from hashjoin3d_tpu_torch.ops.layout import key_column
from hashjoin3d_tpu_torch.ops import strands_windowed as tw
from hashjoin3d_tpu_torch.ops.nested import build_nested

from test_experiments import GOLDEN, _VALUE_COLS

CPU = "cpu"
EXAMPLES = ("test0", "test1", "test2", "test3")
GOLDENS = [
    ("e1_R6_S8_uni_t0.csv", dict(log2_card_r=6, log2_card_s=8, skew=False,
                                 t=0, b=1)),
    ("e1_R7_S9_zipf_t2_b2.csv", dict(log2_card_r=7, log2_card_s=9, skew=True,
                                     t=2, b=2)),
]


def _rows(top, cols):
    """The port's AlgTop result as a sorted multiset of host values."""
    b = top.result
    mask = (b.mask.numpy() if b.mask is not None else np.ones(b.n, bool))
    data = b.to_numpy()
    return sorted(tuple(int(data[c][i]) for c in cols)
                  for i in range(b.n) if mask[i])


def _jax_rows(top, cols):
    b = top.result
    mask = np.asarray(b.mask) if b.mask is not None else np.ones(b.n, bool)
    data = {k: np.asarray(v) for k, v in b.columns.items()}
    return sorted(tuple(int(data[c][i]) for c in cols)
                  for i in range(b.n) if mask[i])


# -- the goldens of tests/test_algebra.py ------------------------------------

def test0_counts_and_rows():
    scan, sel, top = ex.test0(io.StringIO(), CPU)
    assert (top.count(), sel.count(), scan.count()) == (3, 3, 4)
    assert _rows(top, ("a", "b")) == [(1, 11), (2, 21), (3, 31)]


def test1_counts():
    ops = ex.test1(io.StringIO(), CPU)
    assert ops["build"].count() == 6
    assert ops["scan_r"].count() == 6
    assert ops["top"].count() == 3
    assert ops["probe"].count() == 3
    assert ops["sel"].count() == 3
    assert ops["scan_l"].count() == 4


JOIN_ROWS = [(1, 11, 1, -3), (1, 11, 1, -2), (1, 11, 1, -1),
             (2, 21, 2, -2), (2, 21, 2, -1), (3, 31, 3, -1)]


def test2_counts_and_rows():
    ops = ex.test2(io.StringIO(), CPU)
    assert ops["top"].count() == 6
    assert ops["unnest"].count() == 6
    assert ops["probe"].count() == 3
    assert _rows(ops["top"], ("a", "b", "r.c", "r.d")) == JOIN_ROWS


def test3_counts_and_rows():
    ops = ex.test3(io.StringIO(), CPU)
    assert ops["top"].count() == 6
    assert ops["probe"].count() == 6
    assert ops["probe"].num_cmps == 10  # keys 1 and 3 share bucket 2
    assert _rows(ops["top"], ("l.a", "l.b", "r.c", "r.d")) == JOIN_ROWS


def test_print_strand_and_runtimes():
    ops = ex.test3(io.StringIO(), CPU)
    buf = io.StringIO()
    talg.print_strand(ops["scan_l"], 1, buf)
    lines = buf.getvalue().splitlines()
    assert [line.split("|")[0].strip() for line in lines] == [
        "AlgTop", "AlgHashJoinProbe", "AlgSelection", "AlgScan"]
    assert talg.get_runtime_excl(ops["top"]) == ops["top"].runtime()
    assert all(op.runs() == 1 for op in ops.values())


def test_compile_strand_fuses_nested_plan():
    """The fused strand equals the interpreted run: counts, comparison
    counters, result multisets (plans of algebra_test2 / test3); capacity
    hints; a too-small capacity raises."""
    ops = ex.test2(io.StringIO(), CPU)
    want = _rows(ops["top"], ("a", "b", "r.c", "r.d"))
    top = talg.compile_strand(ops["scan_l"])()
    assert top.count() == 6
    assert ops["probe"].count() == 3
    assert ops["probe"].num_cmps == 4
    assert ops["unnest"].count() == 6
    assert ops["sel"].count() == 3
    assert _rows(top, ("a", "b", "r.c", "r.d")) == want

    ops3 = ex.test3(io.StringIO(), CPU)
    want3 = _rows(ops3["top"], ("l.a", "l.b", "r.c", "r.d"))
    top3 = talg.compile_strand(ops3["scan_l"])()
    assert top3.count() == 6
    assert ops3["probe"].count() == 6
    assert ops3["probe"].num_cmps == 10
    assert _rows(top3, ("l.a", "l.b", "r.c", "r.d")) == want3

    ops2 = ex.test2(io.StringIO(), CPU)
    run2 = talg.compile_strand(ops2["scan_l"],
                               out_sizes={ops2["probe"]: 8,
                                          ops2["unnest"]: 8})
    assert run2().count() == 6
    run_small = talg.compile_strand(ops2["scan_l"],
                                    out_sizes={ops2["unnest"]: 2})
    with pytest.raises(ValueError, match="capacity"):
        run_small()


# -- against the JAX algebra -------------------------------------------------

def _strand_lines(print_fn, scan):
    """print_strand's lines without the runtimes: (name, count, runs)."""
    buf = io.StringIO()
    print_fn(scan, 1, buf)
    return [tuple(line.strip().split("|")[i] for i in (0, 1, 3))
            for line in buf.getvalue().splitlines()]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_plans_match_jax(name):
    jout, tout = io.StringIO(), io.StringIO()
    want = getattr(jex, name)(jout)
    got = getattr(ex, name)(tout, CPU)
    if name == "test0":
        want = dict(zip(("scan", "sel", "top"), want))
        got = dict(zip(("scan", "sel", "top"), got))
    assert set(got) == set(want)
    for k in want:
        assert got[k].count() == want[k].count(), k
        assert got[k].name == want[k].name
        if hasattr(want[k], "num_cmps"):
            assert got[k].num_cmps == want[k].num_cmps, k
    cols = list(want["top"].result.columns)
    assert list(got["top"].result.columns) == cols
    assert _rows(got["top"], cols) == _jax_rows(want["top"], cols)
    for scan in ("scan", "scan_l", "scan_r"):
        if scan in want:
            assert (_strand_lines(talg.print_strand, got[scan])
                    == _strand_lines(jalg.print_strand, want[scan]))
    # the printed tuples, as a multiset (row order is the layout's)
    printed = [ln for ln in tout.getvalue().splitlines()
               if ln.startswith("(")]
    assert sorted(printed) == sorted(ln for ln in jout.getvalue()
                                     .splitlines() if ln.startswith("("))


def _residual_plan(alg, kind, relations, fuse=False):
    """L(a, b) probes R(c, d) with the residual ``b + 10 * d > 0`` under
    ``kind`` ("chaining": the probe filters; "nested": the unnest does)."""
    L, R = relations()
    residual = (lambda p, b: p["b"] + 10 * b["d"] > 0)
    top = alg.AlgTop(io.StringIO())
    if kind == "chaining":
        build = alg.AlgHashJoinBuild("c", 5)
        probe = alg.AlgHashJoinProbe(top, build, "a", residual=residual)
        cols = ("l.a", "l.b", "r.c", "r.d")
        counted = probe
    else:
        build = alg.AlgNestJoinBuild("c", 5)
        counted = alg.AlgUnnestHt(top, residual=residual)
        probe = alg.AlgNestJoinProbe(counted, build, "a")
        cols = ("a", "b", "r.c", "r.d")
    alg.AlgScan(build, R).run()
    scan = alg.AlgScan(probe, L)
    scan.run()
    if fuse:
        top = alg.compile_strand(scan)()
    return top, counted, probe, cols


@pytest.mark.parametrize("kind", ["chaining", "nested"])
def test_residual_predicates_match_jax(kind):
    jtop, jcounted, jprobe, cols = _residual_plan(jalg, kind, jex.relations)
    want = _jax_rows(jtop, cols)
    assert want == [(1, 11, 1, -1), (2, 21, 2, -2), (2, 21, 2, -1),
                    (3, 31, 3, -1)]
    for fuse in (False, True):
        top, counted, probe, _ = _residual_plan(
            talg, kind, lambda: ex.relations(CPU), fuse)
        assert _rows(top, cols) == want
        assert top.count() == jtop.count() == 4
        assert counted.count() == jcounted.count() == 4
        assert probe.num_cmps == jprobe.num_cmps


def test_u32_values_at_and_above_2_31():
    """A u32 column on its int32 carrier: predicates see its unsigned
    values, the result columns and printed rows give them back, and the
    join keys hash their bits, as in the JAX package."""
    a = np.array([5, 2**31, 2**32 - 1, 7, 2**31 + 9], np.uint32)
    b = np.array([1, 2, 3, 4, 5], np.int32)
    c = np.array([2**32 - 1, 2**31, 2**32 - 1, 11], np.uint32)
    outs = {}
    for name, alg, rel in (("jax", jalg, lambda **k: jalg.Relation(**k)),
                           ("port", talg,
                            lambda **k: talg.Relation(CPU, **k))):
        buf = io.StringIO()
        top = alg.AlgTop(buf, True,
                         lambda r, o: o.write(f"({r['a']},{r['b']})"))
        sel = alg.AlgSelection(top, lambda cols: cols["a"] > 2**31 - 1)
        alg.AlgScan(sel, rel(a=a, b=b)).run()
        jtop = alg.AlgTop(io.StringIO())
        build = alg.AlgHashJoinBuild("c", 3)
        alg.AlgScan(build, rel(c=c)).run()
        probe = alg.AlgHashJoinProbe(jtop, build, "a")
        alg.AlgScan(probe, rel(a=a, b=b)).run()
        outs[name] = (sel.count(), sorted(buf.getvalue().splitlines()),
                      probe.count(), probe.num_cmps, jtop)
    assert outs["port"][:4] == outs["jax"][:4]
    assert outs["port"][1] == ["(2147483648,2)", "(2147483657,5)",
                               "(4294967295,3)"]
    cols = ("l.a", "l.b", "r.c")
    assert _rows(outs["port"][4], cols) == _jax_rows(outs["jax"][4], cols)
    assert (2**32 - 1, 3, 2**32 - 1) in _rows(outs["port"][4], cols)
    res = outs["port"][4].result.to_numpy()
    assert res["l.a"].dtype == np.uint32 and res["l.b"].dtype == np.int32


def test_relation_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default does not raise here")
    with pytest.raises(RuntimeError, match="cuda"):
        talg.Relation(a=np.arange(4, dtype=np.uint32))


# -- the harnesses' clarity strands ------------------------------------------

def _csv_rows(text):
    rows = list(csv.reader(io.StringIO(text), delimiter=";"))
    return rows[0], {r[9]: r for r in rows[1:]}


@pytest.mark.parametrize("golden,params", GOLDENS)
def test_exp1_clarity_rows_match_reference(golden, params):
    """R.k declared not dense after ``init``: Csr, CsrUU and Nsr build R
    compacted and probe with the clarity strands; their rows equal the
    reference's."""
    buf = io.StringIO()
    exp = Experiment1(**params, measure_file=buf, min_runtime_s=0.0,
                      min_repeat=1, trace=False,
                      plans=("Csr", "CsrUU", "Nsr"), device=CPU)
    exp.init()
    assert exp.dense_direct_r
    exp.dense_direct_r = False
    exp.run()
    hdr, got = _csv_rows(buf.getvalue())
    ref_hdr, ref = _csv_rows((GOLDEN / golden).read_text())
    assert hdr == ref_hdr
    cols = _VALUE_COLS(hdr)
    for plan in ("Csr", "CsrUU", "Nsr"):
        assert [got[plan][i] for i in cols] == [ref[plan][i] for i in cols]
        table, out = exp.results[plan]
        assert table.direct is None and out["route_worst"] == 0
    with pytest.raises(AssertionError, match="dense-direct"):
        exp.join_plan("CsrSel")


@pytest.mark.parametrize("strand", ["chaining_unique", "chaining", "nested",
                                    "nested_nounnest"])
def test_exp1_clarity_strands_match_jax(strand):
    """The exp-1 clarity strands on a JAX-built compacted table carried by
    ``convert.py`` (2^14 duplicate-heavy build rows, a permutation of 2^13
    probes): arrays and counters bit-equal to the JAX strands; counters
    and pairs (nested tuples) equal to the windowed strand's."""
    rng = np.random.default_rng(3)
    dom, P = 1024, 8192
    bk = rng.integers(0, dom, 1 << 14, dtype=np.uint32)
    pk = rng.permutation(P).astype(np.uint32)
    ndv = int(np.unique(bk).size)
    tpk = key_column(pk, CPU)
    if strand.startswith("chaining"):
        jt = jax_chaining_host(bk, ndv, n_keys=ndv, key_domain=dom)
        table = chaining_table_from_numpy(
            _fields(jt, CHAINING_FIELDS + ("key_direct",)), num_buckets=ndv,
            hashfun="murmur", device=CPU)
        unique = strand == "chaining_unique"
        out_size = P if unique else 1 << 15
        want = jexp1._chaining_probe_strand(jt, jnp.asarray(pk), out_size,
                                            unique)
        got = texp1._chaining_probe_strand(table, tpk, out_size, unique)
        win = tw.keydirect_chaining_strand_sorted(table, tpk, out_size,
                                                  unique=unique)
    else:
        jt = jax_nested_host(bk, ndv, n_keys=ndv, key_domain=dom)
        table = nested_table_from_numpy(_fields(jt, NESTED_FIELDS),
                                        num_buckets=ndv, hashfun="murmur",
                                        device=CPU)
        if strand == "nested":
            want = jexp1._nested_probe_strand(jt, jnp.asarray(pk), 1 << 15)
            got = texp1._nested_probe_strand(table, tpk, 1 << 15)
            win = tw.keydirect_nested_strand_sorted(table, tpk, 1 << 15,
                                                    do_unnest=True)
        else:
            want = jexp1._nested_probe_strand_nounnest(jt, jnp.asarray(pk))
            got = texp1._nested_probe_strand_nounnest(table, tpk)
            win = tw.keydirect_nested_strand_sorted(table, tpk, 1,
                                                    do_unnest=False)
    assert got["route_worst"] == 0
    for k, v in want.items():
        if k.startswith("c_") or k == "total":
            assert int(got[k]) == int(v) == int(win[k]), k
        else:
            assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    if strand == "nested_nounnest":
        hit = got["nested_hit"].numpy()
        have = sorted(zip(np.nonzero(hit)[0].tolist(),
                          got["nested_g"].numpy()[hit].tolist()))
        wh = win["nested_hit"].numpy()
        assert have == sorted(zip(win["nested_probe_row"].numpy()[wh]
                                  .tolist(),
                                  win["nested_g"].numpy()[wh].tolist()))
    else:
        def pairs(o):
            live = o["probe_row"].numpy() >= 0
            return sorted(zip(o["probe_row"].numpy()[live].tolist(),
                              o["build_row"].numpy()[live].tolist()))
        assert pairs(got) == pairs(win)


def _fields(table, names) -> dict:
    out = {}
    for f in names:
        obj = table
        for part in f.split("."):
            obj = getattr(obj, part)
        if obj is not None:
            out[f] = np.asarray(obj)
    return out


def _triples(out, valid=None):
    r, s, t = (np.asarray(out[k]) if not isinstance(out[k], torch.Tensor)
               else out[k].numpy() for k in ("r_row", "s_row", "t_row"))
    live = r >= 0 if valid is None else valid
    return sorted(zip(r[live].tolist(), s[live].tolist(), t[live].tolist()))


@pytest.mark.parametrize("shape", [(6, 2, 2, 3, 2), (10, 2, 3, 3, 2)])
def test_exp4_clarity_strands_match_jax(shape):
    e = Experiment4(*shape, plans=("none",), device=CPU)
    sa, ta = exp4_data(*shape)
    rk = np.arange(e.card_r, dtype=np.uint32)
    ndv = e.num_fk_common + e.num_fk_exclusive
    c1, c2 = e.calc_join_card1(), e.calc_join_card2()
    oracle = sorted((int(k), int(si), int(ti)) for k in rk
                    for si in np.nonzero(sa == k)[0]
                    for ti in np.nonzero(ta == k)[0])
    jk, tk = jnp.asarray(rk), key_column(rk, CPU)
    jn_s, jn_t = jax_nested(sa, ndv), jax_nested(ta, ndv)
    tn_s = build_nested(key_column(sa, CPU), ndv)
    tn_t = build_nested(key_column(ta, CPU), ndv)
    jc_s, jc_t = jax_chaining(sa, ndv), jax_chaining(ta, ndv)
    tc_s = build_chaining(key_column(sa, CPU), ndv)
    tc_t = build_chaining(key_column(ta, CPU), ndv)
    runs = {
        "Ndu": (jexp4._ndu_probe_strand(jn_s, jn_t, jk, c2 // 2, c2),
                texp4._ndu_probe_strand(tn_s, tn_t, tk, c2 // 2, c2)),
        "Chj": (jexp4._chj_probe_strand(jc_s, jc_t, jk, c1, c2),
                texp4._chj_probe_strand(tc_s, tc_t, tk, c1, c2)),
        "Nnu": (jexp4._nnu_probe_strand(jn_s, jn_t, jk),
                texp4._nnu_probe_strand(tn_s, tn_t, tk)),
    }
    for plan, (want, got) in runs.items():
        assert set(got) == set(want), plan
        for k in want:
            if k.startswith("c_"):
                assert int(got[k]) == int(want[k]), (plan, k)
            else:  # row and group columns, array for array
                assert np.array_equal(got[k].numpy(), np.asarray(want[k])), \
                    (plan, k)
        if plan != "Nnu":
            assert _triples(got) == oracle, plan
            assert int(got["c_top"]) == c2 == len(oracle)
    assert int(runs["Nnu"][1]["c_top"]) == e.num_fk_common
