"""The port's experiment 4 (R |><| S |><| T, deferred unnesting) on the CPU
against the JAX package and the reference binaries' golden CSVs.

Exact equality throughout (integer work: the tolerance is zero):

* ``exp4_data`` bit-equal to the JAX package's generator;
* ``ndu_strand_sorted``, ``chj_strand_sorted`` and ``nnu_strand_sorted`` on
  tables the JAX package built, carried across by ``convert.py``: counters
  equal to the JAX strands', result triples equal to each other, to the
  JAX strands' and to a numpy oracle, as multisets;
* ``Experiment4(device="cpu")`` rows Ndu and Chj equal to both golden CSVs
  in every value column, Nnu's ``c_top`` = numFkCommon, route 0;
* the plan resolution, the derived cardinalities, the parameter table and
  the small-R warning against the JAX harness's;
* the port's exp-4 CLI in a subprocess (CSV to stdout, ``--no-run``, a
  CUDA request without a GPU).
"""

import csv
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hashjoin3d_tpu.models.exp4 import Experiment4 as JaxExperiment4
from hashjoin3d_tpu.ops.chaining import build_chaining_host as jax_chaining
from hashjoin3d_tpu.ops.nested import build_nested_host as jax_nested
from hashjoin3d_tpu.ops.strands_windowed import (
    chj_strand_sorted as jax_chj, ndu_strand_sorted as jax_ndu,
    nnu_strand_sorted as jax_nnu)
from hashjoin3d_tpu.utils.gen import exp4_data as jax_exp4_data

from hashjoin3d_tpu_torch.convert import (CHAINING_FIELDS, NESTED_FIELDS,
                                          OPTIONAL_FIELDS,
                                          chaining_table_from_numpy,
                                          nested_table_from_numpy)
from hashjoin3d_tpu_torch.models import exp4 as texp4
from hashjoin3d_tpu_torch.models.exp4 import Experiment4
from hashjoin3d_tpu_torch.ops import sort as tsort
from hashjoin3d_tpu_torch.ops import strands_windowed as tw
from hashjoin3d_tpu_torch.utils.gen import exp4_data

from test_experiments import GOLDEN, _VALUE_COLS
from test_torch_merged import recorded

REPO = Path(__file__).resolve().parent.parent
GOLDENS = [("e4_R8_a3_A3_b2_B1.csv", (8, 3, 3, 2, 1)),
           ("e4_R6_a2_A2_b3_B2.csv", (6, 2, 2, 3, 2))]
#: a larger shape: 2^12 R keys, 3072 rows in S and T, groups of 4 and 2
SHAPE = (12, 4, 4, 2, 2)


@pytest.mark.parametrize("params", [(8, 3, 3, 2, 1), (6, 2, 2, 3, 2),
                                    SHAPE, (10, 1, 3, 1, 2)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_exp4_data_matches_jax(params, shuffle):
    got = exp4_data(*params, shuffle=shuffle)
    want = jax_exp4_data(*params, shuffle=shuffle)
    for g, w in zip(got, want):
        assert g.dtype == np.uint32 and np.array_equal(g, w)


def _fields(table, names):
    out = {}
    for f in names:
        obj = table
        for part in f.split("."):
            obj = getattr(obj, part)
        out[f] = np.asarray(obj)
    return out


@pytest.fixture(scope="module")
def tables():
    """JAX-built S and T tables of both kinds at ``SHAPE`` (the harness's
    builds), with their port copies, and R.k."""
    e = JaxExperiment4(*SHAPE, plans=("none",))
    sa, ta = jax_exp4_data(*SHAPE)
    ndv = e.num_fk_common + e.num_fk_exclusive
    dom = e.num_fk_common + 2 * e.num_fk_exclusive
    out = dict(exp=e, sa=sa, ta=ta, rk=np.arange(e.card_r, dtype=np.uint32))
    for rel, keys in (("s", sa), ("t", ta)):
        jn = jax_nested(keys, ndv, n_keys=ndv, key_domain=dom)
        jc = jax_chaining(keys, ndv, n_keys=ndv, key_domain=dom,
                          early_exit_index=False)
        out[f"nested_{rel}"] = (jn, nested_table_from_numpy(
            _fields(jn, NESTED_FIELDS), num_buckets=jn.num_buckets,
            hashfun=jn.hashfun, device="cpu"))
        out[f"chaining_{rel}"] = (jc, chaining_table_from_numpy(
            _fields(jc, CHAINING_FIELDS + OPTIONAL_FIELDS),
            num_buckets=jc.num_buckets, hashfun=jc.hashfun, device="cpu"))
    return out


def triples(out):
    r, s, t = (np.asarray(out[k]) for k in ("r_row", "s_row", "t_row"))
    live = r >= 0
    return sorted(zip(r[live].tolist(), s[live].tolist(), t[live].tolist()))


def oracle_triples(rk, sa, ta):
    """R |><| S |><| T in numpy: (R row, S row, T row) for R.k == S.a ==
    T.a (R.k is the iota, so the R row is the key)."""
    return sorted((int(k), int(si), int(ti)) for k in rk
                  for si in np.nonzero(sa == k)[0]
                  for ti in np.nonzero(ta == k)[0])


COUNTERS = ("c_probe_RS", "c_probe_RS_cmp", "c_probe_RT", "c_probe_RT_cmp")


@pytest.mark.parametrize("plan", ["Ndu", "Chj"])
def test_strands_match_jax_and_oracle(plan, tables, monkeypatch):
    e = tables["exp"]
    walks = recorded(monkeypatch, tw, "miss_chain_sum")
    k4 = recorded(monkeypatch, tsort, "bitonic_sort_segmented")
    kind = "nested" if plan == "Ndu" else "chaining"
    (js, ps), (jt, pt) = tables[f"{kind}_s"], tables[f"{kind}_t"]
    rk = tables["rk"]
    c1, c2 = e.calc_join_card1(), e.calc_join_card2()
    if plan == "Ndu":
        out1 = c2 // e.mult_alpha
        want = jax_ndu(js, jt, rk, out1, c2)
        got = tw.ndu_strand_sorted(ps, pt, torch.from_numpy(
            rk.view(np.int32)), out1, c2)
        extra = ("c_unnest_1", "c_unnest_2")
    else:
        want = jax_chj(js, jt, rk, c1, c2)
        got = tw.chj_strand_sorted(ps, pt, torch.from_numpy(
            rk.view(np.int32)), c1, c2)
        extra = ("c_top",)
    for k in COUNTERS + extra:
        assert int(got[k]) == int(want[k]), k
    oracle = oracle_triples(rk, tables["sa"], tables["ta"])
    assert len(oracle) == c2
    assert triples(got) == triples(want) == oracle
    assert got["route_worst"] == 0 == int(want["route_worst"])
    # the iota probes are not sorted; Chj's S walk is one MW call
    assert k4 == []
    if plan == "Chj":
        assert walks == [1]


def test_nnu_strand_matches_jax(tables):
    e = tables["exp"]
    (js, ps), (jt, pt) = tables["nested_s"], tables["nested_t"]
    rk = tables["rk"]
    want = jax_nnu(js, jt, rk)
    got = tw.nnu_strand_sorted(ps, pt, torch.from_numpy(rk.view(np.int32)))
    for k in COUNTERS + ("c_top",):
        assert int(got[k]) == int(want[k]), k
    assert int(got["c_top"]) == e.num_fk_common
    for k in ("g_s", "g_t"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert got["route_worst"] == 0


def test_probes_iota_is_the_permutation_route(tables):
    """The nested strand's iota route (exp-4's R.k) gives the pairs and
    counters of its permutation route on the same keys."""
    _, ps = tables["nested_s"]
    rk = torch.from_numpy(tables["rk"].view(np.int32))
    out_size = tables["sa"].size
    for unnest in (True, False):
        a = tw.keydirect_nested_strand_sorted(ps, rk, out_size,
                                              do_unnest=unnest,
                                              probes_iota=True)
        b = tw.keydirect_nested_strand_sorted(ps, rk, out_size,
                                              do_unnest=unnest,
                                              probes_permutation=True)
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]),
                               torch.as_tensor(b[k])), (unnest, k)


def _rows(text):
    rows = list(csv.reader(io.StringIO(text), delimiter=";"))
    return rows[0], {r[10]: r for r in rows[1:]}


def _check_rows(text, golden):
    ref_hdr, ref = _rows((GOLDEN / golden).read_text())
    hdr, got = _rows(text)
    assert hdr == ref_hdr == texp4.CSV_HEADER
    cols = _VALUE_COLS(hdr)
    for plan, want in ref.items():
        assert [got[plan][i] for i in cols] == [want[i] for i in cols], plan
    return hdr, got


@pytest.mark.parametrize("golden,params", GOLDENS)
def test_exp4_rows_match_reference(golden, params):
    buf = io.StringIO()
    exp = Experiment4(*params, measure_file=buf, min_runtime_s=0.0,
                      min_repeat=1, trace=False, plans=("all", "Nnu"),
                      device="cpu")
    exp.init()
    exp.run()
    hdr, got = _check_rows(buf.getvalue(), golden)
    assert list(got) == ["Ndu", "Chj", "Nnu"]
    assert int(got["Nnu"][hdr.index("c_top")]) == exp.num_fk_common
    for plan, (_, _, out) in exp.results.items():
        assert out["route_worst"] == 0, plan


@pytest.mark.parametrize("items", [["all"], ["none"], ["Nnu"], ["nnu"],
                                   ["5"], ["7"], ["Ndu,2"], ["all,Nnu"]])
def test_plan_resolution_matches_jax(items):
    assert texp4.resolve_plans(items) == JaxExperiment4._resolve_plans(items)
    with pytest.raises(ValueError, match="Nxx"):
        texp4.resolve_plans(["Ndu,Nxx"])


@pytest.mark.parametrize("params", [(8, 3, 3, 2, 1), SHAPE, (10, 1, 1, 1, 1),
                                    (24, 4, 4, 2, 2)])
def test_cardinalities_and_config_match_jax(params, capsys):
    got = Experiment4(*params, plans=("none",), device="cpu")
    want = JaxExperiment4(*params, plans=("none",))
    for k in ("card_r", "card_s", "card_t", "num_fk_common",
              "num_fk_exclusive"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.calc_join_card1() == want.calc_join_card1()
    assert got.calc_join_card2() == want.calc_join_card2()
    bufs = io.StringIO(), io.StringIO()
    got.print_config(bufs[0])
    want.print_config(bufs[1])
    assert bufs[0].getvalue() == bufs[1].getvalue()


def test_param_table_matches_jax():
    bufs = io.StringIO(), io.StringIO()
    Experiment4.print_param_table(bufs[0], log2_range=(2, 4))
    JaxExperiment4.print_param_table(bufs[1], log2_range=(2, 4))
    assert bufs[0].getvalue() == bufs[1].getvalue()


def test_small_r_warns_and_runs(capsys):
    """-R 10 -a 1 -b 1: T's exclusive FK values pass R's domain; the run
    warns, as the reference's does, and those rows never match."""
    buf = io.StringIO()
    exp = Experiment4(10, 1, 1, 1, 1, measure_file=buf, min_runtime_s=0.0,
                      min_repeat=1, trace=False, plans=("Nnu",),
                      device="cpu")
    exp.init()
    assert "cardR < numFkCommon" in capsys.readouterr().err
    exp.run()
    _, got = _rows(buf.getvalue())
    assert int(got["Nnu"][-1]) == exp.num_fk_common


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "hashjoin3d_tpu_torch.exp4", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_cli_writes_the_reference_rows():
    r = _cli("-R", "8", "-a", "3", "-A", "3", "-b", "2", "-B", "1",
             "--measure-file", "-", "--device", "cpu", "--min-time-ms", "0",
             "--min-repeat", "1", "--print-timers")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "card(j(R,S,T)): 288" in r.stdout and "runNdu|" in r.stdout
    csv_text = "\n".join(line for line in r.stdout.splitlines()
                         if line.count(";") > 20)
    _check_rows(csv_text, "e4_R8_a3_A3_b2_B1.csv")


def test_cli_no_run_and_cuda_request(tmp_path):
    out = tmp_path / "e4.csv"
    r = _cli("-R", "6", "-a", "2", "-A", "2", "-b", "3", "-B", "2",
             "--measure-file", str(out), "--device", "cpu", "--no-run",
             "--print-relations")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "-- T --" in r.stdout
    assert not out.exists() or out.read_text() == ""  # no rows written
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the CUDA request is valid")
    r = _cli("-R", "6", "-a", "2", "-A", "2", "-b", "3", "-B", "2",
             "--measure-file", str(out))
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
