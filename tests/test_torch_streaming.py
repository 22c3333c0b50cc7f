"""The port's out-of-core streaming probes on the CPU against the JAX
package and the insertion-simulating oracle.

Same seeded numpy inputs on both sides, exact equality (integer work: the
tolerance is zero): ``stream_probe_chaining`` / ``stream_probe_nested`` of
``hashjoin3d_tpu_torch.ops.streaming`` hold

* against the JAX package's ``stream_probe_*`` and its whole-column
  strands and probes (``tests/test_ops_misc.py``'s four streaming cases,
  the pad-bucket functor case among them);
* on every layout (dense-direct, key_direct, merged u32, merged u64) x
  functor (murmur, boncz, fib, mult, identity) x table (chaining with and
  without ``unique``, nested), with a ragged tail chunk, against
  ``tests/oracle.py`` and, under murmur, JAX's whole-column probe;
* in a seeded sweep in the manner of ``tools/fuzz_stream.py`` against the
  oracle.

Counters are bit-equal and pairs equal as multisets.  The JAX package
reserves the all-ones key as its merged streams' chunk padding, so no
case here probes it.  The CPU path is the plain version of the CUDA loop
(pinned buffers and a side stream), which only the H100 runs
(``chip_smoke.py`` phase 9).
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hashjoin3d_tpu.models.exp1 import _chaining_probe_strand as jax_chain_strand
from hashjoin3d_tpu.ops.chaining import build_chaining_host as jax_chaining
from hashjoin3d_tpu.ops.chaining import (
    materialize_chaining_join as jax_materialize)
from hashjoin3d_tpu.ops.chaining import probe_chaining as jax_probe_chaining
from hashjoin3d_tpu.ops.hashing import HASH_FUNCTORS_NP, hash_key_np
from hashjoin3d_tpu.ops.nested import build_nested_host as jax_nested
from hashjoin3d_tpu.ops.nested import probe_nested as jax_probe_nested
from hashjoin3d_tpu.ops.nested import unnest as jax_unnest
from hashjoin3d_tpu.ops.streaming import (
    stream_probe_chaining as jax_stream_chaining,
    stream_probe_nested as jax_stream_nested)

from hashjoin3d_tpu_torch.ops.chaining import build_chaining_host
from hashjoin3d_tpu_torch.ops.layout import key_column
from hashjoin3d_tpu_torch.ops.nested import build_nested_host
from hashjoin3d_tpu_torch.ops.streaming import (ChunkStager,
                                                stream_probe_chaining,
                                                stream_probe_nested)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from oracle import ChainingOracle, NestedOracle  # noqa: E402

LAYOUTS = ("dense", "key_direct", "merged_u32", "merged_u64")
FUNCTORS = ("murmur", "boncz", "fib", "mult", "identity")
TABLES = (("chaining", True), ("chaining", False), ("nested", True))


def flat(pairs):
    return sorted((int(a), int(b)) for pr, br in pairs
                  for a, b in zip(pr, br))


def valid_pairs(prow, brow, valid=None):
    prow, brow = np.asarray(prow), np.asarray(brow)
    v = prow >= 0 if valid is None else np.asarray(valid)
    return sorted(zip(prow[v].tolist(), brow[v].tolist()))


def port_chaining(bk, nb, **kw):
    return build_chaining_host(key_column(bk, "cpu"), nb, **kw)


def port_nested(bk, nb, **kw):
    return build_nested_host(key_column(bk, "cpu"), nb, **kw)


# -- tests/test_ops_misc.py's streaming cases on the port ----------------------

def test_stream_probe_matches_whole_column():
    """Streamed == whole-column on a dense-direct table (counters and pair
    multiset), with a ragged tail chunk; equal to JAX's stream."""
    rng = np.random.default_rng(13)
    n = 4096
    bk = rng.permutation(n).astype(np.uint32)
    pk = rng.integers(0, n + 32, 10000, dtype=np.uint32)  # ragged vs 4096
    jt = jax_chaining(bk, n, dense_direct=True, n_keys=n)
    want = jax.device_get(jax_chain_strand(jt, jax.device_put(pk), pk.size,
                                           True))
    tbl = port_chaining(bk, n, dense_direct=True, n_keys=n)
    m, c, pairs = stream_probe_chaining(tbl, pk, chunk_size=4096,
                                        unique=True, collect_pairs=True)
    assert m == int(want["c_htProbe"])
    assert c == int(want["c_htProbeCmp"])
    assert flat(pairs) == valid_pairs(want["probe_row"], want["build_row"])
    jm, jc, jpairs = jax_stream_chaining(jt, pk, chunk_size=4096,
                                         unique=True, collect_pairs=True)
    assert (m, c) == (jm, jc)
    assert flat(pairs) == flat(jpairs)


def test_stream_probe_dense_direct_nonmurmur_buckets():
    """Dense-direct streaming under boncz where the murmur and boncz pad
    buckets differ in length (the JAX package's pad-correction escape):
    the port has no pad, and its counters equal the whole column's."""
    rng = np.random.default_rng(13)
    n = 4096
    bk = rng.permutation(n).astype(np.uint32)
    pk = rng.integers(0, n + 32, 10000, dtype=np.uint32)
    pad = np.uint32(0xFFFFFFFF)
    for nb in range(61, 257):
        blen = np.bincount(hash_key_np(bk, "boncz") % np.uint32(nb),
                           minlength=nb)
        if (blen[int(hash_key_np(pad, "murmur") % np.uint32(nb))]
                != blen[int(hash_key_np(pad, "boncz") % np.uint32(nb))]):
            break
    else:
        pytest.fail("no num_buckets separates the pad buckets")
    jt = jax_chaining(bk, nb, dense_direct=True, n_keys=n, hashfun="boncz")
    want = jax.device_get(jax_chain_strand(jt, jax.device_put(pk), pk.size,
                                           True))
    tbl = port_chaining(bk, nb, dense_direct=True, n_keys=n, hashfun="boncz")
    m, c, _ = stream_probe_chaining(tbl, pk, chunk_size=4096, unique=True)
    assert m == int(want["c_htProbe"])
    assert c == int(want["c_htProbeCmp"])


def nested_columns(layout, rng):
    if layout == "keydirect":
        return (rng.integers(0, 1024, 4096, dtype=np.uint32),
                rng.integers(0, 1100, 10000, dtype=np.uint32), 1100)
    if layout == "merged_u32":
        return ((rng.integers(0, 1024, 4096, dtype=np.uint32)
                 * 65521 + 3).astype(np.uint32),
                (rng.integers(0, 1100, 10000, dtype=np.uint32)
                 * 65521 + 3).astype(np.uint32), None)
    hi = np.uint64(0x3) << np.uint64(40)
    return (rng.integers(0, 1024, 4096).astype(np.uint64) | hi,
            rng.integers(0, 1100, 10000).astype(np.uint64) | hi, None)


@pytest.mark.parametrize("layout", ["keydirect", "merged_u32", "merged_u64"])
def test_stream_probe_nested_matches_whole_column(layout):
    """Streamed nested probe + unnest == whole-column ``probe_nested`` +
    ``unnest`` of the JAX package, and == its stream."""
    bk, pk, kd = nested_columns(layout, np.random.default_rng(17))
    ndv = int(np.unique(bk).size)
    jt = jax_nested(bk, ndv, n_keys=ndv, key_domain=kd)
    res = jax_probe_nested(jt, jax.device_put(pk))
    total = int(np.sum(np.asarray(jax.device_get(res.group_len))))
    prow, brow, valid, _ = jax_unnest(jt, res, max(1, total))
    tbl = port_nested(bk, ndv, n_keys=ndv, key_domain=kd)
    m, c, u, pairs = stream_probe_nested(tbl, pk, chunk_size=4096,
                                         collect_pairs=True,
                                         out_per_chunk=8 * 4096)
    assert (m, c, u) == (int(res.num_matches), int(res.num_cmps), total)
    assert flat(pairs) == valid_pairs(prow, brow, valid)
    jm, jc, ju, jpairs = jax_stream_nested(jt, pk, chunk_size=4096,
                                           collect_pairs=True,
                                           out_per_chunk=8 * 4096)
    assert (m, c, u) == (jm, jc, ju)
    assert flat(pairs) == flat(jpairs)


@pytest.mark.parametrize("unique", [False, True])
def test_stream_probe_chaining_keydirect_and_merged(unique):
    """Streamed chaining probes on key_direct and merged u64 tables ==
    JAX's whole-column ``probe_chaining`` + ``materialize_chaining_join``."""
    rng = np.random.default_rng(19)
    if unique:
        base = rng.permutation(1 << 16)[:2048].astype(np.uint32)
    else:
        base = rng.integers(0, 512, 2048, dtype=np.uint32)
    for kd, tr in ((1 << 16, lambda a: a),
                   (None, lambda a: a.astype(np.uint64)
                    | (np.uint64(9) << np.uint64(40)))):
        bk = tr(base)
        pk = tr(np.concatenate([rng.choice(base, 9000),
                                rng.integers(1 << 17, 1 << 18, 1000)
                                ]).astype(base.dtype))
        ndv = int(np.unique(bk).size)
        jt = jax_chaining(bk, ndv, n_keys=ndv, key_domain=kd)
        res = jax_probe_chaining(jt, jax.device_put(pk), unique=unique)
        total = int(res.num_matches)
        prow, brow, valid, _ = jax_materialize(jt, res, max(1, total),
                                               unique=unique)
        tbl = port_chaining(bk, ndv, n_keys=ndv, key_domain=kd)
        assert (tbl.key_direct is not None) == (kd is not None)
        m, c, pairs = stream_probe_chaining(
            tbl, pk, chunk_size=4096, unique=unique, collect_pairs=True,
            out_per_chunk=16 * 4096)
        assert (m, c) == (total, int(res.num_cmps))
        assert flat(pairs) == valid_pairs(prow, brow, valid)


# -- layouts x functors x tables ------------------------------------------------

def layout_case(layout, how, unique, hashfun, seed):
    """(build keys, probe keys, num_buckets, build kwargs) of one case:
    2000-3000 build rows, 3001 probes (ragged against 700-key chunks)."""
    rng = np.random.default_rng(seed)
    n_p = 3001
    if layout == "dense":
        n_b = 2048
        bk = rng.permutation(n_b).astype(np.uint32)
        pk = rng.integers(0, n_b + 64, n_p, dtype=np.uint32)
        kw = dict(dense_direct=True, n_keys=n_b)
        if how == "chaining" and not unique:
            kw["full_chain_index"] = True
        nb = 701
    else:
        n_b = 2500
        dom = 900 if not unique else 1 << 14
        bk = (rng.permutation(dom)[:n_b] if unique and how == "chaining"
              else rng.integers(0, dom, n_b)).astype(np.uint32)
        pk = rng.integers(0, dom + 64, n_p, dtype=np.uint32)
        if layout == "merged_u32":
            bk = bk * np.uint32(65521) + np.uint32(3)
            pk = pk * np.uint32(65521) + np.uint32(3)
        elif layout == "merged_u64":
            hi = np.uint64(0x5D) << np.uint64(36)
            bk = bk.astype(np.uint64) | hi
            pk = pk.astype(np.uint64) | hi
        ndv = int(np.unique(bk).size)
        kw = dict(n_keys=ndv)
        if layout == "key_direct":
            kw["key_domain"] = int(pk.max()) + 1
        nb = max(ndv // 2, 1)
    return bk, pk, nb, dict(kw, hashfun=hashfun)


def oracle_hash(hashfun, wide):
    f = HASH_FUNCTORS_NP[hashfun][1 if wide else 0]
    t = np.uint64 if wide else np.uint32
    return lambda k: int(f(t(k)))


@pytest.mark.parametrize("how,unique", TABLES)
@pytest.mark.parametrize("hashfun", FUNCTORS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_stream_layout_functor(layout, hashfun, how, unique):
    """Each layout x functor x table, ragged tail: the port's stream ==
    the oracle (counters, pairs) and, under murmur, JAX's whole-column
    probe (counters; the JAX package's own tests hold its other functors
    to the same oracle, and each functor compiles its own JAX probe)."""
    seed = LAYOUTS.index(layout) * 10 + FUNCTORS.index(hashfun)
    bk, pk, nb, kw = layout_case(layout, how, unique, hashfun, seed)
    hf = oracle_hash(hashfun, bk.dtype.itemsize == 8)
    if how == "chaining":
        tbl = port_chaining(bk, nb, **kw)
        m, c, pairs = stream_probe_chaining(tbl, pk, chunk_size=700,
                                            unique=unique,
                                            collect_pairs=True,
                                            out_per_chunk=16 * 700)
        if hashfun == "murmur":
            jt = jax_chaining(bk, nb, **kw)
            res = jax_probe_chaining(jt, jax.device_put(pk), unique=unique)
        want_pairs, om, oc = ChainingOracle(bk, nb, hashfun=hf).probe(
            pk, unique=unique)
        u = ou = None
    else:
        tbl = port_nested(bk, nb, **kw)
        m, c, u, pairs = stream_probe_nested(tbl, pk, chunk_size=700,
                                             collect_pairs=True,
                                             out_per_chunk=16 * 700)
        if hashfun == "murmur":
            jt = jax_nested(bk, nb, **kw)
            res = jax_probe_nested(jt, jax.device_put(pk))
        nested, om, oc = NestedOracle(bk, nb, hashfun=hf).probe(pk)
        want_pairs = NestedOracle.unnest(nested)
        ou = len(want_pairs)
    assert (tbl.direct is not None) == (layout == "dense")
    assert (tbl.key_direct is not None) == (layout == "key_direct")
    if hashfun == "murmur":
        assert (m, c) == (int(res.num_matches), int(res.num_cmps))
    assert (m, c, u) == (om, oc, ou)
    assert flat(pairs) == sorted(want_pairs)
    assert m > 0


# -- a seeded sweep in the manner of tools/fuzz_stream.py -----------------------

def sweep_trial(rng):
    layout = str(rng.choice(LAYOUTS))
    hf = str(rng.choice(FUNCTORS))
    how = str(rng.choice(["chaining", "nested"]))
    unique = bool(rng.random() < 0.5)
    n_p = int(rng.integers(1, 3000))
    chunk = int(rng.integers(32, 1500))
    if layout == "dense":
        n_b = int(rng.integers(1, 2048))
        bk = rng.permutation(n_b).astype(np.uint32)
        pk = rng.integers(0, n_b + 32, n_p, dtype=np.uint32)
    else:
        n_b = int(rng.integers(1, 2000))
        dom = int(rng.integers(2, 3 * max(n_b, 4)))
        bk = rng.integers(0, dom, n_b, dtype=np.uint32)
        pk = rng.integers(0, dom + 8, n_p, dtype=np.uint32)
        if layout == "merged_u32":
            bk = bk * np.uint32(65521) + np.uint32(3)
            pk = pk * np.uint32(65521) + np.uint32(3)
        elif layout == "merged_u64":
            hi = np.uint64(int(rng.integers(1, 1 << 16))) << np.uint64(40)
            bk = bk.astype(np.uint64) | hi
            pk = pk.astype(np.uint64) | hi
    ndv = int(np.unique(bk).size)
    nb = int(rng.integers(1, 2 * ndv + 2))
    kw = dict(hashfun=hf)
    if layout == "dense":
        nb = min(nb, n_b)
        kw.update(dense_direct=True, n_keys=n_b)
        if how == "chaining" and not unique:
            kw["full_chain_index"] = True
    elif layout == "key_direct":
        kw.update(key_domain=int(pk.max()) + 1, n_keys=ndv)
    hfn = oracle_hash(hf, bk.dtype.itemsize == 8)
    cfg = (layout, hf, how, unique, n_b, n_p, nb, chunk)
    if how == "chaining":
        tbl = port_chaining(bk, nb, **kw)
        want, om, oc = ChainingOracle(bk, nb, hashfun=hfn).probe(
            pk, unique=unique)
        m, c, got = stream_probe_chaining(
            tbl, pk, chunk_size=chunk, unique=unique, collect_pairs=True,
            out_per_chunk=16 * chunk + 16)
        assert (m, c) == (om, oc), cfg
    else:
        tbl = port_nested(bk, nb, **kw)
        nested, om, oc = NestedOracle(bk, nb, hashfun=hfn).probe(pk)
        want = NestedOracle.unnest(nested)
        m, c, u, got = stream_probe_nested(
            tbl, pk, chunk_size=chunk, collect_pairs=True,
            out_per_chunk=16 * chunk + 16)
        assert (m, c, u) == (om, oc, len(want)), cfg
    assert flat(got) == sorted(want), cfg


@pytest.mark.parametrize("seed", range(4))
def test_stream_fuzz_sweep(seed):
    """Eight random trials a seed: layout x functor x table x chunk size
    (ragged tails) against the oracle."""
    rng = np.random.default_rng(20261017 + seed)
    for _ in range(8):
        sweep_trial(rng)


# -- the loop itself -----------------------------------------------------------

def test_stream_edges_and_refusals(tmp_path):
    """A memmap column, an empty column and one chunk bigger than the
    column; u64 probes of a u32 table, ``unique=False`` on a dense table
    without ``full_chain_index`` and an overflowing chunk raise."""
    rng = np.random.default_rng(3)
    n = 1024
    bk = rng.permutation(n).astype(np.uint32)
    pk = rng.integers(0, n + 16, 5000, dtype=np.uint32)
    tbl = port_chaining(bk, 257, dense_direct=True, n_keys=n)
    path = tmp_path / "probes.u32"
    pk.tofile(path)
    mm = np.memmap(path, dtype=np.uint32, mode="r")
    whole = stream_probe_chaining(tbl, pk, chunk_size=1 << 20)
    assert stream_probe_chaining(tbl, mm, chunk_size=999) == whole
    assert stream_probe_chaining(tbl, pk[:0]) == (0, 0, [])
    assert whole[0] == int((pk < n).sum())
    with pytest.raises(ValueError, match="truncate"):
        stream_probe_chaining(tbl, pk.astype(np.uint64))
    with pytest.raises(ValueError, match="full_chain_index"):
        stream_probe_chaining(tbl, pk, unique=False)
    dup = rng.integers(0, 8, 512, dtype=np.uint32)
    ntbl = port_nested(dup, 8, n_keys=8, key_domain=8)
    with pytest.raises(ValueError, match="out_per_chunk"):
        stream_probe_nested(ntbl, np.zeros(300, np.uint32), chunk_size=100,
                            collect_pairs=True, out_per_chunk=100)
    # narrow and signed host columns take their u32 bits
    st = ChunkStager(np.array([-1, 5], np.int16), 4, True,
                     torch.device("cpu"))
    st.stage(0)
    assert st.take(0).tolist() == [0xFFFFFFFF, 5]


def test_oocbench_models_match_the_stream():
    """``tools/oocbench.py``'s numpy cost models hold against the oracle
    at 2^12 and equal the port's streamed counters at 2^14 probes (ragged
    3000-key chunks); the tool itself refuses to run without a card."""
    from hashjoin3d_tpu_torch.tools import oocbench

    rng = np.random.default_rng(1)
    n = 1 << 12
    keys = rng.permutation(n).astype(np.uint32)
    nb = n // 2
    probes = rng.integers(0, n, 1 << 13).astype(np.uint32)
    _, m, c = ChainingOracle(keys, nb).probe(probes, unique=True)
    cost = oocbench.chaining_unique_cost(keys, nb)
    assert (m, c) == (probes.size, int(cost[probes].sum()))
    bkeys = rng.integers(0, n, n * 4).astype(np.uint32)
    ncost, gsize = oocbench.nested_cost_and_groups(bkeys, nb, n)
    nora = NestedOracle(bkeys, nb)
    nested, nm, nc = nora.probe(probes)
    assert (nm, nc, len(nora.unnest(nested))) == (
        int((gsize[probes] > 0).sum()), int(ncost[probes].sum()),
        int(gsize[probes].sum()))

    R, P = 1 << 10, 1 << 14
    probes = rng.integers(0, R, P, dtype=np.uint32)
    keys = rng.permutation(R).astype(np.uint32)
    bkeys = rng.integers(0, R, 1 << 12, dtype=np.uint32)
    cost = oocbench.chaining_unique_cost(keys, R)
    tbl = port_chaining(keys, R, dense_direct=True, n_keys=R)
    assert stream_probe_chaining(tbl, probes, chunk_size=3000)[:2] == (
        P, int(cost[probes].sum()))
    ncost, gsize = oocbench.nested_cost_and_groups(bkeys, R, R)
    ntbl = port_nested(bkeys, R, n_keys=int((gsize > 0).sum()),
                       key_domain=R)
    assert stream_probe_nested(ntbl, probes, chunk_size=3000)[:3] == (
        int((gsize[probes] > 0).sum()), int(ncost[probes].sum()),
        int(gsize[probes].sum()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            oocbench.main(["--logp", "12", "--logr", "10", "--logb", "11",
                           "--logc", "10"])
