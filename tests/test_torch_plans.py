"""The port's exp-1 plans on the CPU against the JAX package.

* ``resolve_plan_items`` against the JAX harness's: names, ``all``,
  ``none``, numeric masks, an unknown name;
* the CsrUU and Nsr strands (``direct_probe_strand_sorted`` with
  ``unique=False`` and ``nested=True``) on a hit-only stream (packed sort
  route) and a stream with misses (wide-key route and the miss walk):
  counters equal, result pairs equal as multisets;
* CsrUU's chaining table built by the JAX package, carried over with
  ``convert.py`` and probed by the port;
* ``Experiment1(device="cpu")`` rows of ``all`` (scr ... NrsNU) against
  both golden CSVs of the reference binaries (the ``_VALUE_COLS`` rule of
  ``test_experiments.py``);
* the port's exp-1 CLI in a subprocess on the CPU: the same rows, Crs and
  ``all`` against the golden CSV, CsrSel and CrsSel (``-p 256``) against
  the JAX harness's rows.
"""

import csv
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hashjoin3d_tpu.models import exp1 as jexp1
from hashjoin3d_tpu.ops.chaining import build_chaining_host as jax_chaining
from hashjoin3d_tpu.ops.nested import build_nested_host as jax_nested
from hashjoin3d_tpu.ops.strands_windowed import (
    direct_probe_strand_sorted as jax_strand)

from hashjoin3d_tpu_torch.convert import (FIELDS, OPTIONAL_FIELDS,
                                          chaining_table_from_numpy)
from hashjoin3d_tpu_torch.models import exp1 as texp1
from hashjoin3d_tpu_torch.models.exp1 import Experiment1
from hashjoin3d_tpu_torch.ops import strands_windowed as tw
from hashjoin3d_tpu_torch.ops.chaining import build_chaining_host
from hashjoin3d_tpu_torch.ops.layout import from_numpy_u32
from hashjoin3d_tpu_torch.ops.nested import build_nested_host

from test_experiments import GOLDEN, _VALUE_COLS

REPO = Path(__file__).resolve().parent.parent
PORTED = ["scr", "scs", "Csr", "CsrUU", "Crs", "Nsr", "Nrs", "NrsNU"]
GOLDENS = [
    ("e1_R6_S8_uni_t0.csv", dict(log2_card_r=6, log2_card_s=8, skew=False,
                                 t=0, b=1)),
    ("e1_R7_S9_zipf_t2_b2.csv", dict(log2_card_r=7, log2_card_s=9, skew=True,
                                     t=2, b=2)),
]


def t32(a):
    return from_numpy_u32(np.asarray(a), "cpu")


def pairs(out):
    prow, brow = np.asarray(out["probe_row"]), np.asarray(out["build_row"])
    hit = prow >= 0
    return sorted(zip(prow[hit].tolist(), brow[hit].tolist()))


@pytest.mark.parametrize("items", [
    ["Csr,Nrs"], ["all"], ["none"], ["4,8"], ["12"], ["all,CsrSel"],
    ["none", "8192", "NrsNU"], ["96"],
])
def test_resolve_plan_items_matches_jax(items):
    want = jexp1.resolve_plan_items(items, jexp1.PLAN_NAMES, jexp1.PLAN_BITS,
                                    all_names=jexp1.DEFAULT_PLANS)
    got = texp1.resolve_plan_items(items, texp1.PLAN_NAMES, texp1.PLAN_BITS,
                                   all_names=texp1.DEFAULT_PLANS)
    assert got == want


def test_resolve_plan_items_rejects_unknown_names():
    for mod in (jexp1, texp1):
        with pytest.raises(ValueError, match="Cxx"):
            mod.resolve_plan_items(["Csr,Cxx"], mod.PLAN_NAMES,
                                   mod.PLAN_BITS)


def test_plan_tables_match_jax():
    assert texp1.PLAN_NAMES == jexp1.PLAN_NAMES
    assert texp1.DEFAULT_PLANS == jexp1.DEFAULT_PLANS
    assert texp1.PLAN_BITS == jexp1.PLAN_BITS
    assert texp1.CSV_HEADER == jexp1._CSV_HEADER
    assert texp1.DEFAULT_PLANS == PORTED


@pytest.mark.parametrize("hi,sort_route", [
    (4096, "bitonic_sort_packed_segmented"),   # hit-only, keys < 2^key_bits
    (4096 + 64, "sort_segmented"),             # wider keys: misses
])
@pytest.mark.parametrize("plan", ["CsrUU", "Nsr"])
def test_strand_matches_jax(plan, hi, sort_route, monkeypatch):
    rng = np.random.default_rng(1)
    n, nb, P = 4096, 1500, 16384
    bk = rng.permutation(n).astype(np.uint32)
    pk = rng.integers(0, hi, P, dtype=np.uint32)
    calls = []
    real = getattr(tw, sort_route)
    monkeypatch.setattr(tw, sort_route,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    if plan == "CsrUU":
        jt = jax_chaining(bk, nb, dense_direct=True, n_keys=n,
                          full_chain_index=True)
        pt = build_chaining_host(t32(bk), nb, dense_direct=True, n_keys=n,
                                 full_chain_index=True)
        kw = dict(unique=False)
    else:
        jt = jax_nested(bk, nb, dense_direct=True, n_keys=n)
        pt = build_nested_host(t32(bk), nb, dense_direct=True, n_keys=n)
        kw = dict(nested=True)
    want = jax_strand(jt, pk, **kw)
    got = tw.direct_probe_strand_sorted(pt, t32(pk), **kw)
    counters = ("c_htProbe", "c_htProbeCmp", "total") + (
        ("c_unnest",) if plan == "Nsr" else ())
    for k in counters:
        assert int(got[k]) == int(want[k]), k
    assert pairs(got) == pairs(want)
    assert calls == [1]
    assert got["route_worst"] == 0
    assert (int(got["c_htProbe"]) < P) == (hi > n)


def test_port_probes_a_jax_built_csruu_table():
    rng = np.random.default_rng(2)
    n, nb, P = 2048, 1000, 8192
    bk = rng.permutation(n).astype(np.uint32)
    pk = rng.integers(0, n + n // 4, P, dtype=np.uint32)
    pk[:64] = 2**32 - 1 - np.arange(64, dtype=np.uint32)  # keys >= 2^31
    jt = jax_chaining(bk, nb, dense_direct=True, n_keys=n,
                      full_chain_index=True)
    port = chaining_table_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in FIELDS + OPTIONAL_FIELDS},
        num_buckets=jt.num_buckets, direct_shift=jt.direct_shift,
        hashfun=jt.hashfun, device="cpu")
    assert port.chain_by_key is not None
    want = jax_strand(jt, pk, unique=False)
    got = tw.direct_probe_strand_sorted(port, t32(pk), unique=False)
    for k in ("c_htProbe", "c_htProbeCmp", "total"):
        assert int(got[k]) == int(want[k]), k
    assert pairs(got) == pairs(want)


def _rows(text):
    rows = list(csv.reader(io.StringIO(text), delimiter=";"))
    return rows[0], {r[9]: r for r in rows[1:]}


def _check_rows(text, golden, plans=PORTED):
    ref_hdr, ref = (_rows((GOLDEN / golden).read_text())
                    if isinstance(golden, str) else golden)
    got_hdr, got = _rows(text)
    assert got_hdr == ref_hdr
    assert sorted(got) == sorted(plans)
    cols = _VALUE_COLS(ref_hdr)
    for plan, row in got.items():
        want = ref[plan]
        assert len(row) == len(want), plan  # scan rows omit reps
        assert [row[i] for i in cols if i < len(row)] == [
            want[i] for i in cols if i < len(want)], plan


@pytest.mark.parametrize("golden,params", GOLDENS)
def test_exp1_rows_match_reference(golden, params):
    buf = io.StringIO()
    exp = Experiment1(**params, measure_file=buf, min_runtime_s=0.0,
                      min_repeat=1, trace=False, device="cpu")
    exp.init()
    exp.run()
    _check_rows(buf.getvalue(), golden)
    for plan in PORTED[2:]:
        assert exp.results[plan][1]["route_worst"] == 0, plan


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "hashjoin3d_tpu_torch.exp1", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_cli_writes_the_reference_rows(tmp_path):
    out = tmp_path / "e1.csv"
    r = _cli("-R", "7", "-S", "9", "--skew", "-t", "2", "-b", "2",
             "--measure-file", str(out), "--device", "cpu",
             "--min-time-ms", "0", "--min-repeat", "1", "-p",
             "scr,scs,Csr,CsrUU,Crs,Nsr,Nrs,NrsNU", "--print-timers")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "runNrs|" in r.stdout
    _check_rows(out.read_text(), "e1_R7_S9_zipf_t2_b2.csv")


@pytest.fixture(scope="module")
def jax_sel_rows():
    """The JAX harness's CsrSel and CrsSel rows at the zipf golden's
    parameters."""
    buf = io.StringIO()
    exp = jexp1.Experiment1(**GOLDENS[1][1], measure_file=buf,
                            min_runtime_s=0.0, min_repeat=1, trace=False,
                            backend="device", plans=("CsrSel", "CrsSel"))
    exp.init()
    exp.run()
    return _rows(buf.getvalue())


@pytest.mark.parametrize("plans", ["Crs", "all", "CsrSel", "256"])
def test_cli_pending_plan_exits_naming_its_slice(plans, tmp_path,
                                                 jax_sel_rows):
    """The plans that were pending run from the CLI: Crs and ``all`` give
    the golden rows, CsrSel and CrsSel (bit 256) the JAX harness's."""
    out = tmp_path / "e1.csv"
    r = _cli("-R", "7", "-S", "9", "--skew", "-t", "2", "-b", "2",
             "--device", "cpu", "--min-time-ms", "0", "--min-repeat", "1",
             "--measure-file", str(out), "-p", plans)
    assert r.returncode == 0, r.stdout + r.stderr
    want = {"Crs": ["Crs"], "all": PORTED, "CsrSel": ["CsrSel"],
            "256": ["CrsSel"]}[plans]
    golden = ("e1_R7_S9_zipf_t2_b2.csv" if plans in ("Crs", "all")
              else jax_sel_rows)
    _check_rows(out.read_text(), golden, want)
