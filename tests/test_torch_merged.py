"""The port's merged strands, probe ops and directory lookups on the CPU
against the JAX package.

Same seeded numpy inputs on both sides, exact equality (integer work: the
tolerance is zero):

* ``merged_nested_strand_sorted`` and ``merged_chaining_strand_sorted``
  (``unique`` on and off) over JAX-built tables carried across by
  ``convert.py``, for sparse u32, u64 and composite keys, with misses and a
  probe equal to the padding key: counters bit-equal, result pairs equal as
  multisets, routes equal; their sizing passes (``do_unnest=False`` /
  ``do_expand=False``) give the same counters and the result count;
* ``probe_chaining`` (dense-direct with and without ``unique``,
  ``key_direct``, and the directory lookup by search and by merge) and
  ``probe_nested`` (dense-direct, ``key_direct``, search, merge), each with
  and without ``mask``: hit masks, match counts, counters and the hits'
  group ids equal, and the chain walk summed by one MW call; their
  counters on the compacted sparse u32, u64 and composite tables;
* ``lookup``, ``merge_lookup`` (with a mask) and ``key_direct_lookup`` on
  u32 and u64 directories.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashjoin3d_tpu.ops import layout as jl
from hashjoin3d_tpu.ops.chaining import build_chaining_host as jax_chaining
from hashjoin3d_tpu.ops.chaining import probe_chaining as jax_probe_chaining
from hashjoin3d_tpu.ops.nested import build_nested_host as jax_nested
from hashjoin3d_tpu.ops.nested import probe_nested as jax_probe_nested
from hashjoin3d_tpu.ops.strands_windowed import (
    merged_chaining_strand_sorted as jax_merged_chaining,
    merged_nested_strand_sorted as jax_merged_nested)

from hashjoin3d_tpu_torch.convert import (CHAINING_FIELDS, FIELDS,
                                          NESTED_DENSE_FIELDS, NESTED_FIELDS,
                                          OPTIONAL_FIELDS,
                                          chaining_table_from_numpy,
                                          nested_table_from_numpy)
from hashjoin3d_tpu_torch.ops import chaining as tchaining
from hashjoin3d_tpu_torch.ops import layout as tl
from hashjoin3d_tpu_torch.ops import nested as tnested
from hashjoin3d_tpu_torch.ops import sort as tsort
from hashjoin3d_tpu_torch.ops import strands_windowed as tw
from hashjoin3d_tpu_torch.ops.chaining import probe_chaining
from hashjoin3d_tpu_torch.ops.layout import key_column, pack2u32
from hashjoin3d_tpu_torch.ops.nested import probe_nested

N = 1 << 12          # build rows
P = 1 << 13          # probe rows
#: the materialising passes' buffer: above every kind's result count, and
#: one size for all, so the JAX side compiles each strand once a key width
OUT = 1 << 15
KINDS = ("sparse32", "u64", "composite")
U64_MAX = np.uint64(2**64 - 1)


def fields(table, names):
    out = {}
    for f in names:
        obj = table
        for part in f.split("."):
            obj = getattr(obj, part)
        out[f] = np.asarray(obj)
    return out


def carrier(a):
    return key_column(a, "cpu")


def recorded(monkeypatch, module, name):
    """A list that grows by one at each call of ``module.name``."""
    calls, real = [], getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def pairs(out):
    prow, brow = np.asarray(out["probe_row"]), np.asarray(out["build_row"])
    hit = prow >= 0
    return sorted(zip(prow[hit].tolist(), brow[hit].tolist()))


def columns(kind: str):
    """(build keys, probe keys): about four rows a distinct key, probes
    half hits, half misses, with the all-ones key among the probes (the
    directory's padding value; the u64 build holds it as a real key)."""
    rng = np.random.default_rng(KINDS.index(kind))
    if kind == "sparse32":
        vals = rng.choice(2**32 - 2, N // 4, replace=False).astype(np.uint32)
        miss = rng.integers(0, 2**32 - 1, P, dtype=np.uint64).astype(
            np.uint32)
        pad = np.uint32(2**32 - 1)
    elif kind == "u64":
        vals = rng.integers(0, 2**64 - 1, N // 4, dtype=np.uint64)
        vals[:3] = [U64_MAX, 2**63, 2**32 - 1]
        miss = rng.integers(0, 2**64 - 1, P, dtype=np.uint64)
        pad = U64_MAX
    else:
        hi = rng.integers(0, 4, N // 4)
        lo = rng.integers(0, 1 << 10, N // 4)
        vals = np.unique(pack2u32(hi, lo))
        miss = pack2u32(rng.integers(0, 8, P), rng.integers(0, 1 << 10, P))
        pad = U64_MAX
    bk = vals[rng.integers(0, vals.size, N)]
    pk = np.where(rng.random(P) < 0.5, vals[rng.integers(0, vals.size, P)],
                  miss)
    pk[7] = pad
    return bk, pk


@pytest.fixture(scope="module")
def tables():
    """JAX-built compacted nested and chaining tables of each kind (one
    read of the distinct count, no key domain: the merged strands' case),
    with their port copies."""
    out = {}
    for kind in KINDS:
        bk, pk = columns(kind)
        nb = 1 << 10  # one bucket count: the JAX side compiles once a width
        jn = jax_nested(jnp.asarray(bk), nb)
        jc = jax_chaining(jnp.asarray(bk), nb)
        tn = nested_table_from_numpy(fields(jn, NESTED_FIELDS),
                                     num_buckets=nb, hashfun=jn.hashfun,
                                     device="cpu")
        tc = chaining_table_from_numpy(
            fields(jc, CHAINING_FIELDS + OPTIONAL_FIELDS), num_buckets=nb,
            hashfun=jc.hashfun, device="cpu")
        out[kind] = dict(bk=bk, pk=pk, jn=jn, jc=jc, tn=tn, tc=tc)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_merged_nested_strand_matches_jax(tables, kind):
    t = tables[kind]
    want = jax_merged_nested(t["jn"], jnp.asarray(t["pk"]), OUT)
    got = tw.merged_nested_strand_sorted(t["tn"], carrier(t["pk"]), OUT)
    for k in ("c_htProbe", "c_htProbeCmp", "c_unnest", "total",
              "route_worst"):
        assert int(got[k]) == int(want[k]), k
    assert 0 < int(want["c_unnest"]) < OUT
    assert pairs(got) == pairs(want)
    # the sizing pass: the same counters and the exact unnested size
    size = tw.merged_nested_strand_sorted(t["tn"], carrier(t["pk"]), 1,
                                          do_unnest=False)
    for k, w in (("c_htProbe", "c_htProbe"), ("c_htProbeCmp", "c_htProbeCmp"),
                 ("c_expand_total", "c_unnest")):
        assert int(size[k]) == int(want[w]), k


@pytest.mark.parametrize("unique", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_merged_chaining_strand_matches_jax(tables, kind, unique,
                                           monkeypatch):
    t = tables[kind]
    walks = recorded(monkeypatch, tw, "miss_chain_sum")
    k4 = recorded(monkeypatch, tsort, "bitonic_sort_segmented")
    want = jax_merged_chaining(t["jc"], jnp.asarray(t["pk"]), OUT,
                               unique=unique)
    got = tw.merged_chaining_strand_sorted(t["tc"], carrier(t["pk"]), OUT,
                                           unique=unique)
    # the chain walk (every probe's, or the misses') is one MW call
    assert walks == [1] and k4 == []
    for k in ("c_htProbe", "c_htProbeCmp", "total", "route_worst"):
        assert int(got[k]) == int(want[k]), k
    assert 0 < int(want["total"]) < OUT
    assert int(want["total"]) == int(want["c_htProbe"])
    assert pairs(got) == pairs(want)
    # the sizing pass: the same counters, no expansion
    size = tw.merged_chaining_strand_sorted(
        t["tc"], carrier(t["pk"]), 1, unique=unique, do_expand=False)
    assert set(size) == {"c_htProbe", "c_htProbeCmp", "route_worst",
                         "route_nbad"}
    for k in ("c_htProbe", "c_htProbeCmp"):
        assert int(size[k]) == int(want[k]), k


def test_merged_strand_refuses_mixed_key_widths(tables):
    t = tables["sparse32"]
    wide = tl.widen_u64(carrier(t["pk"]))
    with pytest.raises(ValueError, match="widen"):
        tw.merged_nested_strand_sorted(t["tn"], wide, 8)


def probe_result_equal(got, want, what):
    hit = np.asarray(want.hit)
    assert np.array_equal(got.hit.numpy(), hit), what
    assert np.array_equal(got.g.numpy()[hit], np.asarray(want.g)[hit]), what
    for k in ("num_matches", "num_cmps"):
        assert int(getattr(got, k)) == int(getattr(want, k)), (what, k)
    if hasattr(want, "match_count"):
        assert np.array_equal(got.match_count.numpy(),
                              np.asarray(want.match_count)), what
        assert got.from_direct == want.from_direct, what
    else:
        assert np.array_equal(got.group_len.numpy(),
                              np.asarray(want.group_len)), what
        assert np.array_equal(got.probe_row.numpy(),
                              np.asarray(want.probe_row)), what


def probe_tables():
    """(name, JAX chaining table, JAX nested table, port chaining, port
    nested, build keys, probe keys) for each probe branch: dense-direct
    (a permutation of [0, n)), key_direct (t=4-like keys over a domain) and
    the plain directory (the same keys, no domain)."""
    rng = np.random.default_rng(11)
    n = N
    perm = rng.permutation(n).astype(np.uint32)
    pk_dense = rng.integers(0, n + n // 4, P).astype(np.uint32)
    pk_dense[3] = 2**32 - 1
    jc = jax_chaining(jnp.asarray(perm), n, dense_direct=True, n_keys=n,
                      full_chain_index=True)
    jn = jax_nested(jnp.asarray(perm), n, dense_direct=True, n_keys=n)
    out = [("dense", jc, jn,
            chaining_table_from_numpy(fields(jc, FIELDS + ("chain_by_key",)),
                                      num_buckets=n, hashfun=jc.hashfun,
                                      direct_shift=jc.direct_shift,
                                      device="cpu"),
            nested_table_from_numpy(fields(jn, NESTED_DENSE_FIELDS),
                                    num_buckets=n, hashfun=jn.hashfun,
                                    direct_shift=jn.direct_shift,
                                    device="cpu"),
            pk_dense)]
    dom = 1 << 9
    keys = rng.integers(0, dom, n).astype(np.uint32)
    pk = rng.integers(0, dom + dom // 2, P).astype(np.uint32)
    pk[5] = 2**32 - 1
    nkeys = np.unique(keys).size
    for name, kd in (("key_direct", dom), ("directory", None)):
        jc = jax_chaining(jnp.asarray(keys), nkeys, key_domain=kd)
        jn = jax_nested(jnp.asarray(keys), nkeys, key_domain=kd)
        out.append((name, jc, jn,
                    chaining_table_from_numpy(
                        fields(jc, CHAINING_FIELDS + OPTIONAL_FIELDS),
                        num_buckets=nkeys, hashfun=jc.hashfun, device="cpu"),
                    nested_table_from_numpy(
                        fields(jn, NESTED_FIELDS), num_buckets=nkeys,
                        hashfun=jn.hashfun, device="cpu"),
                    pk))
    return out


@pytest.fixture(scope="module")
def probe_cases():
    return probe_tables()


PROBE_BRANCHES = [("dense", "auto"), ("key_direct", "auto"),
                  ("directory", "search"), ("directory", "merge")]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("branch,method", PROBE_BRANCHES)
def test_probe_chaining_matches_jax(probe_cases, branch, method, masked,
                                    monkeypatch):
    _, jc, _, tc, _, pk = next(c for c in probe_cases if c[0] == branch)
    mask = np.random.default_rng(12).random(P) < 0.7
    jmask = jnp.asarray(mask) if masked else None
    tmask = torch.from_numpy(mask) if masked else None
    walks = recorded(monkeypatch, tchaining, "miss_chain_sum")
    for unique in (False, True):
        want = jax_probe_chaining(jc, jnp.asarray(pk), unique=unique,
                                  mask=jmask, method=method)
        walks.clear()
        got = probe_chaining(tc, carrier(pk), unique=unique, mask=tmask,
                             method=method)
        probe_result_equal(got, want, f"{branch} {method} unique={unique}")
        assert walks == [1], (branch, unique)  # every branch has misses


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("branch,method", PROBE_BRANCHES)
def test_probe_nested_matches_jax(probe_cases, branch, method, masked,
                                  monkeypatch):
    _, _, jn, _, tn, pk = next(c for c in probe_cases if c[0] == branch)
    mask = np.random.default_rng(13).random(P) < 0.7
    want = jax_probe_nested(jn, jnp.asarray(pk),
                            mask=jnp.asarray(mask) if masked else None,
                            method=method)
    walks = recorded(monkeypatch, tnested, "miss_chain_sum")
    got = probe_nested(tn, carrier(pk),
                       mask=torch.from_numpy(mask) if masked else None,
                       method=method)
    probe_result_equal(got, want, f"{branch} {method}")
    assert walks == [1]  # every branch has misses
    if branch == "dense":
        hit = np.asarray(want.hit)
        assert np.array_equal(got.direct_row.numpy()[hit],
                              np.asarray(want.direct_row)[hit])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("op", ["chaining", "chaining_unique", "nested"])
@pytest.mark.parametrize("kind", KINDS)
def test_probe_ops_on_compacted_tables_match_jax(tables, kind, op, masked,
                                                 monkeypatch):
    """``probe_chaining`` (``unique`` off and on) and ``probe_nested`` over
    the compacted sparse u32, u64 and composite tables, with and without a
    mask: counters equal to the JAX package's, the chain walk one MW
    call."""
    t = tables[kind]
    pk = t["pk"]
    mask = np.random.default_rng(14).random(pk.size) < 0.7
    jmask = jnp.asarray(mask) if masked else None
    tmask = torch.from_numpy(mask) if masked else None
    if op == "nested":
        walks = recorded(monkeypatch, tnested, "miss_chain_sum")
        want = jax_probe_nested(t["jn"], jnp.asarray(pk), mask=jmask)
        got = probe_nested(t["tn"], carrier(pk), mask=tmask)
    else:
        unique = op == "chaining_unique"
        walks = recorded(monkeypatch, tchaining, "miss_chain_sum")
        want = jax_probe_chaining(t["jc"], jnp.asarray(pk), unique=unique,
                                  mask=jmask)
        got = probe_chaining(t["tc"], carrier(pk), unique=unique,
                             mask=tmask)
    for k in ("num_matches", "num_cmps"):
        assert int(getattr(got, k)) == int(getattr(want, k)), k
    assert int(want.num_cmps) > int(want.num_matches) > 0
    assert walks == [1]


@pytest.mark.parametrize("kind", KINDS)
def test_lookups_match_jax(tables, kind):
    t = tables[kind]
    jg = t["jn"].groups
    tg = t["tn"].groups
    pk = jnp.asarray(t["pk"])
    mask = np.random.default_rng(14).random(P) < 0.6
    cases = (
        (jl.lookup(jg, pk), tl.lookup(tg, carrier(t["pk"]))),
        (jl.merge_lookup(jg, pk), tl.merge_lookup(tg, carrier(t["pk"]))),
        (jl.merge_lookup(jg, pk, jnp.asarray(mask)),
         tl.merge_lookup(tg, carrier(t["pk"]), torch.from_numpy(mask))),
    )
    for (wg, wh), (gg, gh) in cases:
        wh = np.asarray(wh)
        assert np.array_equal(gh.numpy(), wh)
        assert np.array_equal(gg.numpy()[wh], np.asarray(wg)[wh])
    # the merge's group ids equal the search's everywhere, misses included
    assert np.array_equal(np.asarray(cases[1][0][0]), cases[1][1][0].numpy())


def test_key_direct_lookup_matches_jax(probe_cases):
    _, _, jn, _, tn, pk = next(c for c in probe_cases
                               if c[0] == "key_direct")
    want = jl.key_direct_lookup(jn.key_direct, jnp.asarray(pk))
    got = tl.key_direct_lookup(tn.key_direct, carrier(pk))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    wide = np.concatenate([pk.astype(np.uint64),
                           np.array([U64_MAX, 2**63, 5], np.uint64)])
    want = jl.key_direct_lookup(jn.key_direct, jnp.asarray(wide))
    got = tl.key_direct_lookup(tn.key_direct, carrier(wide))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_keydirect_sizing_pass_returns_the_expand_total(probe_cases):
    """The key_direct nested strand's sizing pass (``do_unnest=False``)
    returns ``c_expand_total``, the JAX package's third pass
    (``api._kd_expand_total``), with its counters unchanged."""
    from hashjoin3d_tpu.api import _kd_expand_total
    from hashjoin3d_tpu.ops.strands_windowed import (
        keydirect_nested_strand_sorted as jax_kd_nested)

    _, _, jn, _, tn, pk = next(c for c in probe_cases
                               if c[0] == "key_direct")
    want = jax_kd_nested(jn, jnp.asarray(pk), 1, do_unnest=False)
    got = tw.keydirect_nested_strand_sorted(tn, carrier(pk), 1,
                                            do_unnest=False)
    for k in ("c_htProbe", "c_htProbeCmp", "c_top", "route_worst"):
        assert int(got[k]) == int(want[k]), k
    total = int(_kd_expand_total(jn, jnp.asarray(pk)))
    assert int(got["c_expand_total"]) == total > 0
