"""The port's exp-1 plan Csr end to end on the CPU against the JAX package.

* the port's windowed probe strand against
  ``direct_probe_strand_sorted(unique=True)``: counters bit-equal, result
  pairs equal as multisets, on streams that take the packed sort route and
  the wide-key route with its miss walk;
* a table the JAX package built, carried over with ``convert.py`` and
  probed by the port;
* ``Experiment1(plans=("Csr",), device="cpu")`` against the Csr rows of the
  reference binaries' golden CSVs (the ``_VALUE_COLS`` rule of
  ``test_experiments.py``);
* the CsrSel strand (the mask path) against the JAX package's, and the
  once-pending plans running, with the slice-6 parts still raising;
* the port's rules: no jax import, no silent CPU run for a CUDA request.
"""

import csv
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hashjoin3d_tpu.ops.chaining import build_chaining_host as jax_build
from hashjoin3d_tpu.ops.strands_windowed import (
    direct_probe_strand_sorted as jax_strand)

from hashjoin3d_tpu_torch.convert import FIELDS, chaining_table_from_numpy
from hashjoin3d_tpu_torch.models.exp1 import Experiment1
from hashjoin3d_tpu_torch.ops import strands_windowed as tw
from hashjoin3d_tpu_torch.ops.chaining import (_build_chaining_fused,
                                               build_chaining_host)
from hashjoin3d_tpu_torch.ops.layout import from_numpy_u32

from test_experiments import GOLDEN, _VALUE_COLS

REPO = Path(__file__).resolve().parent.parent


def _pairs(prow, brow):
    prow, brow = np.asarray(prow), np.asarray(brow)
    hit = prow >= 0
    return sorted(zip(prow[hit].tolist(), brow[hit].tolist()))


def _check_against_jax(jax_tbl, port_tbl, pk):
    want = jax_strand(jax_tbl, pk, unique=True)
    got = tw.direct_probe_strand_sorted(port_tbl, from_numpy_u32(pk, "cpu"),
                                        unique=True)
    for k in ("c_htProbe", "c_htProbeCmp", "total"):
        assert int(got[k]) == int(want[k]), k
    assert _pairs(got["probe_row"], got["build_row"]) == _pairs(
        want["probe_row"], want["build_row"])
    return got


@pytest.mark.parametrize("hi,sort_route", [
    (4096, "bitonic_sort_packed_segmented"),   # every key < 2^key_bits
    (4096 + 64, "sort_segmented"),             # wider keys, misses
])
def test_strand_matches_jax(hi, sort_route, monkeypatch):
    rng = np.random.default_rng(1)
    n, P = 4096, 16384
    bk = rng.permutation(n).astype(np.uint32)
    pk = rng.integers(0, hi, P, dtype=np.uint32)
    calls = []
    real = getattr(tw, sort_route)
    monkeypatch.setattr(tw, sort_route,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    port_tbl = build_chaining_host(from_numpy_u32(bk, "cpu"), n,
                                   dense_direct=True, n_keys=n)
    got = _check_against_jax(
        jax_build(bk, n, dense_direct=True, n_keys=n), port_tbl, pk)
    assert calls == [1]
    assert got["route_worst"] == 0
    assert int(got["c_htProbe"]) < P if hi > n else int(got["c_htProbe"]) == P


def test_port_probes_a_jax_built_table():
    rng = np.random.default_rng(2)
    n, nb, P = 2048, 1000, 8192
    bk = rng.permutation(n).astype(np.uint32)
    pk = rng.integers(0, n + n // 4, P, dtype=np.uint32)
    pk[:64] = 2**32 - 1 - np.arange(64, dtype=np.uint32)  # keys >= 2^31
    jax_tbl = jax_build(bk, nb, dense_direct=True, n_keys=n)
    port_tbl = chaining_table_from_numpy(
        {f: np.asarray(getattr(jax_tbl, f)) for f in FIELDS},
        num_buckets=jax_tbl.num_buckets, direct_shift=jax_tbl.direct_shift,
        hashfun=jax_tbl.hashfun, device="cpu")
    _check_against_jax(jax_tbl, port_tbl, pk)


def _csr_row(text):
    rows = list(csv.reader(io.StringIO(text), delimiter=";"))
    return rows[0], next(r for r in rows[1:] if r[9] == "Csr")


@pytest.mark.parametrize("golden,params", [
    ("e1_R6_S8_uni_t0.csv", dict(log2_card_r=6, log2_card_s=8, skew=False,
                                 t=0, b=1)),
    ("e1_R7_S9_zipf_t2_b2.csv", dict(log2_card_r=7, log2_card_s=9, skew=True,
                                     t=2, b=2)),
])
def test_exp1_csr_row_matches_reference(golden, params):
    buf = io.StringIO()
    exp = Experiment1(**params, measure_file=buf, min_runtime_s=0.0,
                      min_repeat=1, trace=False, plans=("Csr",),
                      device="cpu")
    exp.init()
    exp.run()
    ref_hdr, ref = _csr_row((GOLDEN / golden).read_text())
    got_hdr, got = _csr_row(buf.getvalue())
    assert got_hdr == ref_hdr
    cols = _VALUE_COLS(ref_hdr)
    assert [got[i] for i in cols] == [ref[i] for i in cols]


def test_plans_not_yet_ported_name_their_slice():
    """Every exp-1 plan of the JAX harness runs, and so do the hooks that
    the distributed strands and builds use (presorted streams with their
    row ids and windows, the builds' dead all-ones keys and global rows):
    no call names a pending slice any more."""
    exp = Experiment1(6, 8, False, 0, plans=("Crs", "CsrSel", "CrsSel",
                                             "NrsSel"),
                      measure_file=io.StringIO(), min_runtime_s=0.0,
                      min_repeat=1, trace=False, device="cpu")
    exp.init()
    exp.run()
    assert sorted(exp.results) == ["Crs", "CrsSel", "CsrSel", "NrsSel"]
    nrs = exp.join_plan("Nrs").build(exp.sa)
    crs = exp.join_plan("Crs").build(exp.sa)
    pk = torch.sort(exp.rk).values  # R.k presorted: the iota
    rows = torch.arange(pk.shape[0], dtype=torch.int32) + 1000
    for strand, table, window in (
            (tw.keydirect_nested_strand_sorted, nrs, "segment"),
            (tw.keydirect_chaining_strand_sorted, crs, "lookup_w")):
        want = strand(table, exp.rk, 1 << 8)
        for kw in (dict(presorted=True),
                   dict(presorted=True, srow_values=rows),
                   {window: 1024}):
            got = strand(table, pk, 1 << 8, **kw)
            assert int(got["c_htProbe"]) == int(want["c_htProbe"])
            assert int(got["c_htProbeCmp"]) == int(want["c_htProbeCmp"])
        assert int(got["total"]) == int(want["total"])
    keys = from_numpy_u32(np.arange(16, dtype=np.uint32) % 4, "cpu")
    keys[12:] = -1  # a dead tail on the all-ones key
    table = _build_chaining_fused(keys, 8, 4, False, drop_pad_key=True,
                                  rows=torch.arange(16, dtype=torch.int32))
    assert int(table.groups.n_keys) == 4
    assert int(table.bucket_len.sum()) == 12


def test_csrsel_strand_names_slice_3():
    """CsrSel's strand (the mask path of the dense-direct strand) equals the
    JAX package's: only live rows probe, and the predicate's live keys past
    the table, 0xFFFFFFFF among them, count their miss walks."""
    rng = np.random.default_rng(3)
    n, nb, P = 2048, 1000, 8192
    bk = rng.permutation(n).astype(np.uint32)
    pk = rng.integers(0, n + n // 4, P, dtype=np.uint32)
    pk[:64] = 2**32 - 1 - np.arange(64, dtype=np.uint32)  # keys >= 2^31
    mask = rng.random(P) < 0.5
    mask[:8] = True
    jax_tbl = jax_build(bk, nb, dense_direct=True, n_keys=n)
    port_tbl = build_chaining_host(from_numpy_u32(bk, "cpu"), nb,
                                   dense_direct=True, n_keys=n)
    want = jax_strand(jax_tbl, pk, unique=True, mask=mask)
    got = tw.direct_probe_strand_sorted(port_tbl, from_numpy_u32(pk, "cpu"),
                                        unique=True,
                                        mask=torch.from_numpy(mask))
    for k in ("c_htProbe", "c_htProbeCmp", "total"):
        assert int(got[k]) == int(want[k]), k
    assert _pairs(got["probe_row"], got["build_row"]) == _pairs(
        want["probe_row"], want["build_row"])
    assert int(got["c_htProbe"]) < int(mask.sum())


def test_port_imports_no_jax():
    code = ("import sys, hashjoin3d_tpu_torch.models.exp1, "
            "hashjoin3d_tpu_torch.models.exp4, "
            "hashjoin3d_tpu_torch.convert, hashjoin3d_tpu_torch.kernels, "
            "hashjoin3d_tpu_torch.exp1, hashjoin3d_tpu_torch.exp4, "
            "hashjoin3d_tpu_torch.ops.chaining, "
            "hashjoin3d_tpu_torch.ops.strands_windowed, "
            "hashjoin3d_tpu_torch.utils.gen, "
            "hashjoin3d_tpu_torch.ops.nested, "
            "hashjoin3d_tpu_torch.ops.stats, "
            "hashjoin3d_tpu_torch.utils.aggregate, "
            "hashjoin3d_tpu_torch.utils.measure; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'hashjoin3d_tpu.'))]; "
            "sys.exit(f'imported {bad}' if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cuda_request_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the CUDA request is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        Experiment1(6, 8, False, 0, plans=("Csr",), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        from_numpy_u32(np.arange(4, dtype=np.uint32), "cuda")
