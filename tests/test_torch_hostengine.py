"""The port's native host engine, its backends and the functors and
statistics it brings, on the CPU.

Same seeded numpy inputs on both sides, exact equality (integer work: the
tolerance is zero):

* the engine's C++ source is the port's own byte-equal copy of the JAX
  package's (read as a file; nothing of ``hashjoin3d_tpu.hostengine`` is
  called), and a failed ``g++`` build raises;
* ``host_chaining_join`` / ``host_nested_join`` and ``HostTable`` against
  ``tests/oracle.py`` (counters, pairs in emission order) and the port's
  device path on the CPU, in u32 and u64, under every registry functor,
  with the overflow retry; against ``hashjoin3d_tpu.join(backend=
  "device")`` on one u32 and one u64 case (each JAX join compiles for
  seconds);
* ``host_two_join_probe`` against the port's Ndu and Chj strands;
* the exp-1 and exp-4 CLIs with ``--backend host --device cpu`` against
  ``tests/golden/csv/``'s four files;
* ``join(backend="auto")`` under and over a crossover set low, a callable
  functor refused on ``"host"``, the harnesses' ``auto`` routing;
* the CRC, parametric and ``fibhash`` functors and the ``*_np`` statistics
  against the JAX package's.
"""

import io
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import hashjoin3d_tpu as jhj
from hashjoin3d_tpu.ops import hashing as jh
from hashjoin3d_tpu.ops import stats as jstats

import hashjoin3d_tpu_torch as thj
from hashjoin3d_tpu_torch import api, hostengine
from hashjoin3d_tpu_torch.hostengine import (HASHFUN_IDS, HostTable,
                                             host_chaining_join,
                                             host_nested_join,
                                             host_two_join_probe)
from hashjoin3d_tpu_torch.models.exp1 import Experiment1
from hashjoin3d_tpu_torch.models.exp4 import Experiment4
from hashjoin3d_tpu_torch.ops import hashing as th
from hashjoin3d_tpu_torch.ops import stats as tstats
from hashjoin3d_tpu_torch.ops.chaining import build_chaining_host
from hashjoin3d_tpu_torch.ops.layout import key_column
from hashjoin3d_tpu_torch.ops.nested import build_nested_host

sys.path.insert(0, str(Path(__file__).resolve().parent))
from oracle import ChainingOracle, NestedOracle  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "csv"
FUNCTORS = tuple(HASHFUN_IDS)
HOWS = (("nested", False), ("chaining", False), ("chaining", True))


def test_engine_source_is_the_ports_own_copy():
    """The port compiles its own copy of the engine, byte-equal to the JAX
    package's, into its own build directory."""
    port = REPO / "hashjoin3d_tpu_torch"
    assert hostengine.ENGINE_SOURCE.resolve().is_relative_to(port)
    assert (hostengine.ENGINE_SOURCE.read_bytes()
            == (REPO / "hashjoin3d_tpu" / "native" / "hj3engine.cpp")
            .read_bytes())
    so = Path(hostengine.native_engine()._name).resolve()
    assert so.is_relative_to(port / "_build")


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "hj3engine.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(hostengine, "ENGINE_SOURCE", bad)
    monkeypatch.setattr(hostengine, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        hostengine.native_engine()
    with pytest.raises(RuntimeError, match="failed"):
        host_nested_join(np.arange(4, dtype=np.uint32),
                         np.arange(4, dtype=np.uint32), 2)


def columns(width, seed=0):
    rng = np.random.default_rng(seed)
    bk = rng.integers(0, 300, 700).astype(np.uint32)
    pk = rng.integers(0, 380, 900).astype(np.uint32)
    if width == "u64":
        hi = np.uint64(0x2F) << np.uint64(37)
        return bk.astype(np.uint64) | hi, pk.astype(np.uint64) | hi
    return bk, pk


def oracle_hash(hashfun, wide):
    f = th.HASH_FUNCTORS_NP[hashfun][1 if wide else 0]
    t = np.uint64 if wide else np.uint32
    return lambda k: int(f(t(k)))


@pytest.mark.parametrize("how,unique", HOWS)
@pytest.mark.parametrize("hashfun", FUNCTORS)
@pytest.mark.parametrize("width", ["u32", "u64"])
def test_host_join_matches_oracle_and_device(width, hashfun, how, unique):
    """Counters and emission order equal the oracle's; counters and the
    pair multiset equal the port's device path (CPU) at the same buckets."""
    bk, pk = columns(width, FUNCTORS.index(hashfun))
    nb = 97
    hf = oracle_hash(hashfun, width == "u64")
    if how == "chaining":
        op, ob, m, c = host_chaining_join(bk, pk, nb, unique=unique,
                                          hashfun=hashfun)
        pairs, om, oc = ChainingOracle(bk, nb, hashfun=hf).probe(
            pk, unique=unique)
        total = op.size
        assert (m, c) == (om, oc)
        tbl = HostTable(bk, nb, kind="chaining", hashfun=hashfun)
        got = tbl.probe(pk, unique=unique)
    else:
        op, ob, m, c, total = host_nested_join(bk, pk, nb, hashfun=hashfun)
        orc = NestedOracle(bk, nb, hashfun=hf)
        nested, om, oc = orc.probe(pk)
        pairs = orc.unnest(nested)
        assert (m, c, total) == (om, oc, len(pairs))
        tbl = HostTable(bk, nb, kind="nested", hashfun=hashfun)
        got = tbl.probe(pk)
        nu = tbl.probe(pk, unnest=False)
        assert nu[0].size == 0 and nu[2:] == got[2:]
    assert list(zip(op.tolist(), ob.tolist())) == pairs
    assert got[2:] == (m, c, total)[:len(got) - 2]
    assert np.array_equal(got[0], op) and np.array_equal(got[1], ob)
    tbl.close()
    dev = thj.join(bk, pk, how=how, unique=unique, num_buckets=nb,
                   hashfun=hashfun, device="cpu")
    assert (dev.num_matches, dev.num_cmps, dev.num_results) == (m, c, total)
    assert sorted(dev.pairs()) == sorted(pairs)
    assert m > 0


@pytest.mark.parametrize("width,how", [("u32", "nested"),
                                       ("u64", "chaining")])
def test_host_backend_matches_jax_join(width, how):
    bk, pk = columns(width, 7)
    got = thj.join(bk, pk, how=how, backend="host")
    want = jhj.join(bk, pk, how=how, backend="device")
    assert ((got.num_matches, got.num_cmps, got.num_results)
            == (want.num_matches, want.num_cmps, want.num_results))
    assert sorted(got.pairs()) == sorted(want.pairs())
    assert got.probe_rows.dtype == np.int32


def test_overflow_retry_and_refusals():
    """A default capacity short of the result retries once at the exact
    size; an explicit ``out_cap`` short of it raises; u64 probes of a u32
    table and mixed table kinds raise."""
    bk = np.zeros(1000, np.uint32)   # one hot key: 100 x 1000 results
    pk = np.zeros(100, np.uint32)
    op, ob, m, c = host_chaining_join(bk, pk, 4)
    assert m == op.size == 100_000 > 4 * pk.size + bk.size
    op, ob, m, c, u = host_nested_join(bk, pk, 4)
    assert (m, u, op.size) == (100, 100_000, 100_000)
    tbl = HostTable(bk, 4, kind="nested")
    assert tbl.probe(pk)[4] == 100_000
    with pytest.raises(ValueError, match="out_cap"):
        tbl.probe(pk, out_cap=10)
    with pytest.raises(ValueError, match="out_cap"):
        host_chaining_join(bk, pk, 4, out_cap=10)
    with pytest.raises(ValueError, match="truncate"):
        tbl.probe(pk.astype(np.uint64))
    with pytest.raises(ValueError, match="kind"):
        HostTable(bk, 4, kind="cuckoo")
    with pytest.raises(ValueError, match="two kinds"):
        host_two_join_probe(tbl, HostTable(bk, 4, kind="chaining"), pk, 10)
    with pytest.raises(ValueError, match="registry"):
        host_nested_join(bk, pk, 4, hashfun="crc")
    tbl.close()
    tbl.close()  # idempotent


def triples(r, s, t):
    return sorted(zip(np.asarray(r).tolist(), np.asarray(s).tolist(),
                      np.asarray(t).tolist()))


@pytest.mark.parametrize("plan", ["Ndu", "Chj"])
def test_two_join_probe_matches_port_strands(plan):
    """exp-4's probe on the engine == the port's Ndu / Chj strand on the
    CPU: the seven (Chj five) counters, the triples as multisets."""
    exp = Experiment4(9, 2, 3, 3, 2, min_runtime_s=0.0, min_repeat=1,
                      trace=False, device="cpu")
    exp.init()
    nb = exp.num_fk_common + exp.num_fk_exclusive
    ts, tt = exp.build(plan, exp.sa), exp.build(plan, exp.ta)
    want = exp.probe(plan, ts, tt, exp.rk)
    kind = "nested" if plan == "Ndu" else "chaining"
    got = host_two_join_probe(HostTable(exp.sa_np, nb, kind=kind),
                              HostTable(exp.ta_np, nb, kind=kind),
                              np.arange(exp.card_r, dtype=np.uint32),
                              exp.calc_join_card2())
    keys = [k for k in got if k.startswith("c_")]
    assert keys == [k for k in ("c_probe_RS", "c_probe_RS_cmp", "c_probe_RT",
                                "c_probe_RT_cmp", "c_top", "c_unnest_1",
                                "c_unnest_2") if k in got]
    assert {k: got[k] for k in keys} == {k: int(want[k]) for k in keys}
    v = np.asarray(want["r_row"]) >= 0
    assert triples(got["r_row"], got["s_row"], got["t_row"]) == triples(
        *(np.asarray(want[k])[v] for k in ("r_row", "s_row", "t_row")))
    assert got["c_top"] == exp.calc_join_card2()


def _rows(text):
    rows = [line.split(";") for line in text.splitlines() if ";" in line]
    return rows[0], {r[rows[0].index("plan")]: r for r in rows[1:]}


def check_rows(text, golden):
    """Every value column of the golden's rows (the parameters, ht_* and
    c_*; not the timing columns) equals ours."""
    hdr, want = _rows((GOLDEN / golden).read_text())
    got_hdr, got = _rows(text)
    assert got_hdr == hdr
    assert sorted(got) == sorted(set(want) - {"scr", "scs"}) or sorted(
        got) == sorted(want)
    skip = {"mintime", "minreps", "reps"} | {h for h in hdr
                                             if h.startswith("t_")}
    cols = [i for i, h in enumerate(hdr) if h not in skip]
    for plan, row in got.items():
        w = want[plan]
        assert [row[i] for i in cols if i < len(row)] == [
            w[i] for i in cols if i < len(w)], plan


@pytest.mark.parametrize("golden,args", [
    ("e1_R6_S8_uni_t0.csv", "exp1 -R 6 -S 8 --no-skew -t 0 -b 1"),
    ("e1_R7_S9_zipf_t2_b2.csv", "exp1 -R 7 -S 9 --skew -t 2 -b 2"),
    ("e4_R6_a2_A2_b3_B2.csv", "exp4 -R 6 -a 2 -A 2 -b 3 -B 2"),
    ("e4_R8_a3_A3_b2_B1.csv", "exp4 -R 8 -a 3 -A 3 -b 2 -B 1"),
])
def test_cli_host_backend_writes_the_reference_rows(golden, args):
    mod, *rest = args.split()
    r = subprocess.run(
        [sys.executable, "-m", f"hashjoin3d_tpu_torch.{mod}", *rest,
         "--measure-file", "-", "--device", "cpu", "--backend", "host",
         "--min-time-ms", "0", "--min-repeat", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[host]" in r.stdout
    check_rows("\n".join(line for line in r.stdout.splitlines()
                         if line.count(";") > 20), golden)


def test_join_auto_routes_by_crossover(monkeypatch):
    """``auto`` takes the host engine below the crossover (set low here)
    and the device above it; the results agree either way."""
    calls = []
    real = api.host_nested_join

    def spy(*a, **k):
        calls.append(len(a[1]))
        return real(*a, **k)

    monkeypatch.setattr(api, "host_nested_join", spy)
    monkeypatch.setattr(api, "HOST_CROSSOVER_ROWS", 1000)
    bk, pk = columns("u32", 3)
    small = thj.join(bk[:300], pk[:400], backend="auto", device="cpu")
    assert calls == [400]
    big = thj.join(bk, pk, backend="auto", device="cpu")
    assert calls == [400]
    for res, b, p in ((small, bk[:300], pk[:400]), (big, bk, pk)):
        dev = thj.join(b, p, device="cpu")
        assert ((res.num_matches, res.num_cmps, res.num_results)
                == (dev.num_matches, dev.num_cmps, dev.num_results))
        assert sorted(res.pairs()) == sorted(dev.pairs())
    # a callable functor never routes to the host
    thj.join(bk[:300], pk[:400], backend="auto", device="cpu",
             hashfun=lambda k: k)
    assert calls == [400]
    with pytest.raises(ValueError, match="registry"):
        thj.join(bk, pk, backend="host", hashfun=lambda k: k)
    for mode in ("semi", "anti", "left"):
        got = thj.join(bk, pk, backend="host", mode=mode)
        want = thj.join(bk, pk, mode=mode, device="cpu")
        assert sorted(got.pairs()) == sorted(want.pairs()), mode
        assert (got.num_matches, got.num_cmps) == (want.num_matches,
                                                   want.num_cmps)


def test_harness_auto_routes_by_crossover(monkeypatch, capsys):
    """``Experiment1`` / ``Experiment4`` with ``backend="auto"``: plans
    under the crossover run on the host engine, the *Sel plans and Nnu on
    the device, and the default backend is the device."""
    exp = Experiment1(6, 8, False, 0, min_runtime_s=0.0, min_repeat=1,
                      device="cpu", backend="auto",
                      plans=("Csr", "Nrs", "CsrSel"),
                      measure_file=io.StringIO())
    exp.init()
    monkeypatch.setattr(Experiment1, "HOST_CROSSOVER_ROWS", 64 + 256 + 256)
    assert exp._backend_for_plan("Csr") == "device"
    monkeypatch.setattr(Experiment1, "HOST_CROSSOVER_ROWS", 64 + 256 + 257)
    assert [exp._backend_for_plan(p) for p in ("Csr", "NrsNU", "CsrSel")] \
        == ["host", "host", "device"]
    exp.run()
    out = capsys.readouterr().out
    assert "Plan Csr [host]" in out and "Plan Nrs [host]" in out
    assert "Plan CsrSel [cpu]" in out
    assert Experiment1(6, 8, False, 0, device="cpu").backend == "device"
    e4 = Experiment4(8, 3, 3, 2, 1, device="cpu", backend="auto")
    assert e4.backend == "auto"
    assert e4._backend_for_plan("Ndu") == "host"  # 896 rows
    assert e4._backend_for_plan("Nnu") == "device"
    monkeypatch.setattr(Experiment4, "HOST_CROSSOVER_ROWS", 100)
    assert e4._backend_for_plan("Chj") == "device"
    with pytest.raises(ValueError, match="backend"):
        Experiment4(8, 3, 3, 2, 1, device="cpu", backend="tpu")


def test_functors_match_jax():
    """The parametric, Fibonacci and CRC functors equal the JAX package's
    at the u32 / u64 edges, and the SSE4.2 goldens of
    ``tests/test_ops_misc.py``."""
    rng = np.random.default_rng(5)
    x32 = np.concatenate([rng.integers(0, 2**32, 2000, dtype=np.uint64)
                          .astype(np.uint32),
                          np.array([0, 1, 2**31, 2**32 - 1], np.uint32)])
    x64 = np.concatenate([rng.integers(0, 2**64 - 1, 2000, dtype=np.uint64),
                          np.array([0, 1, 2**63, 2**64 - 1], np.uint64)])
    c32, c64 = key_column(x32, "cpu"), key_column(x64, "cpu")
    for n in (100, 1 << 20, float(1 << 32)):
        assert np.array_equal(
            th.fibhash32(c32, n).numpy().view(np.uint32),
            np.asarray(jh.fibhash32(x32, n)))
        assert np.array_equal(th.fibhash32_np(x32, n), jh.fibhash32_np(x32, n))
    for n in (100, 1 << 40, float(1 << 64)):
        assert np.array_equal(
            th.fibhash64(c64, n).numpy().view(np.uint64),
            np.asarray(jh.fibhash64(x64, n)))
    for n in (100, 1 << 40):
        assert np.array_equal(th.fibhash64_np(x64, n), jh.fibhash64_np(x64, n))
    x16 = x32.astype(np.uint16)
    assert np.array_equal(th.fibhash16_np(x16, 77), jh.fibhash16_np(x16, 77))
    for a, b in ((2654435761, 0), (12345, 678), (2**32 - 1, 2**32 - 1)):
        assert np.array_equal(
            th.multiplicative32(c32, a, b).numpy().view(np.uint32),
            np.asarray(jh.multiplicative32(x32, a, b)))
        assert np.array_equal(th.multiplicative32_np(x32, a, b),
                              jh.multiplicative32_np(x32, a, b))
    for a, b in ((11400714819323198485, 0), (12345, 678),
                 (2**64 - 1, 2**64 - 1)):
        assert np.array_equal(
            th.multiplicative64(c64, a, b).numpy().view(np.uint64),
            np.asarray(jh.multiplicative64(x64, a, b)))
        assert np.array_equal(th.multiplicative64_np(x64, a, b),
                              jh.multiplicative64_np(x64, a, b))
    for s in (b"", b"hello", bytes(range(256))):
        assert th.larson_np(s, 3) == jh.larson_np(s, 3)
    for name in ("crc32c_u32_np", "hash_crc32_np"):
        assert np.array_equal(getattr(th, name)(x32), getattr(jh, name)(x32))
    for name in ("crc32c_u64_np", "hash_crc64_np"):
        assert np.array_equal(getattr(th, name)(x64), getattr(jh, name)(x64))
    for mod in (None, 1000):
        assert np.array_equal(th.hash_crc32x2_np(x32, mod),
                              jh.hash_crc32x2_np(x32, mod))
    assert th.CRC_SEED_INITIAL == jh.CRC_SEED_INITIAL
    assert int(th.crc32c_u32_np(np.array([0x12345678], np.uint32))[0]) \
        == 0x4DECE20C
    assert int(th.hash_crc64_np(np.array([0x123456789ABCDEF0],
                                         np.uint64))[0]) == 0x554CA2FDCC86751D


@pytest.mark.parametrize("impl", ["chaining", "nested"])
def test_statistics_np_match_jax_and_tables(impl):
    """``*_statistics_np`` equal the JAX package's and the port's table
    statistics of a table built from the same keys."""
    rng = np.random.default_rng(8)
    bk = rng.integers(0, 2000, 5000).astype(np.uint32)
    nb = 1500
    got = getattr(tstats, f"{impl}_statistics_np")(bk, nb)
    want = getattr(jstats, f"{impl}_statistics_np")(bk, nb)
    assert got.to_csv_fields() == want.to_csv_fields()
    build = build_chaining_host if impl == "chaining" else build_nested_host
    table = build(key_column(bk, "cpu"), nb)
    assert getattr(tstats, f"{impl}_statistics")(table).to_csv_fields() \
        == got.to_csv_fields()


def test_host_engine_needs_no_device():
    """``backend="host"`` runs with the default ``device`` on a host
    without CUDA: the host engine touches no device."""
    bk, pk = columns("u32", 4)
    res = thj.join(bk, pk, backend="host")
    assert res.num_results > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            thj.join(bk, pk)
    assert jax.devices()[0].platform == "cpu"
