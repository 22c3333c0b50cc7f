"""The port's clarity layer on the CPU against the JAX package.

Same seeded numpy inputs on both sides, exact equality (integer work: the
tolerance is zero):

* ``key_group_index`` on u32 and u64 keys, with and without ``valid``
  (all rows dead too), heavy duplicates and live keys equal to the pad
  key, every field bit-equal; ``emit_pos``;
* ``build_chaining`` (``valid``, the early-exit index on and off,
  ``key_domain``, ``dense_direct``, murmur and identity) and
  ``build_nested`` field for field against the JAX package's tables
  carried over by ``convert.py``;
* ``materialize_chaining_join``'s positional, compacted and expanded
  branches (the expanded one with and without ``sync_free``), ``unnest``
  (its direct-row positional branch too) and
  ``deferred_two_join_strand``, array for array against the JAX functions;
* the ``tests/oracle.py`` cases of ``tests/test_tables.py``: chain
  lengths and positions, main-chain positions, counters, result multisets
  and the unnest order per probe row.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hashjoin3d_tpu.ops import layout as jl
from hashjoin3d_tpu.ops import nested as jn
from hashjoin3d_tpu.ops.chaining import build_chaining as jax_chaining
from hashjoin3d_tpu.ops.chaining import materialize_chaining_join as jax_mat
from hashjoin3d_tpu.ops.chaining import probe_chaining as jax_probe_c
from hashjoin3d_tpu.utils import exp4_data

from hashjoin3d_tpu_torch.convert import (CHAINING_FIELDS, FIELDS,
                                          NESTED_DENSE_FIELDS, NESTED_FIELDS,
                                          chaining_table_from_numpy,
                                          nested_table_from_numpy)
from hashjoin3d_tpu_torch.ops import layout as tl
from hashjoin3d_tpu_torch.ops.chaining import (build_chaining,
                                               materialize_chaining_join,
                                               probe_chaining)
from hashjoin3d_tpu_torch.ops.nested import (build_nested,
                                             deferred_two_join_strand,
                                             probe_nested, unnest)

from oracle import ChainingOracle, NestedOracle
from test_tables import workloads

N = 1 << 12
GROUP_FIELDS = ("ukey", "group_start", "group_len", "group_rows",
                "first_row", "gid_by_row", "n_keys")


def carrier(a):
    """A JAX or numpy array as the port's carrier on the CPU."""
    return tl.key_column(np.asarray(a), "cpu") \
        if np.asarray(a).dtype.kind == "u" else torch.from_numpy(
            np.asarray(a).copy())


def same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    if want.dtype.kind == "u":
        want = want.view(np.int32 if want.dtype.itemsize == 4 else np.int64)
    return (tuple(got.shape) == want.shape
            and np.array_equal(got.numpy(), want))


def field(table, name):
    for part in name.split("."):
        table = getattr(table, part)
    return table


def fields_of(table, names) -> dict:
    return {f: np.asarray(field(table, f)) for f in names
            if field(table, f) is not None}


def keys_of(kind: str, width: str):
    """``N`` keys: uniform over 2^9 (8 a key), heavy (zipf-like, one hot
    key), pad (a third equal to the all-ones pad key), wide (the whole
    key range)."""
    rng = np.random.default_rng({"uniform": 0, "heavy": 1, "pad": 2,
                                 "wide": 3}[kind])
    dt = np.uint32 if width == "u32" else np.uint64
    top = np.iinfo(dt).max
    if kind == "uniform":
        keys = rng.integers(0, 1 << 9, N).astype(dt)
    elif kind == "heavy":
        keys = ((rng.zipf(1.2, N) - 1) % 300).astype(dt)
    elif kind == "pad":
        keys = rng.integers(0, 1 << 10, N).astype(dt)
        keys[::3] = top
    else:
        keys = rng.integers(0, top, N, dtype=dt, endpoint=True)
    if width == "u64" and kind in ("uniform", "heavy"):
        keys |= dt(0xAB) << dt(40)  # keys past 2^32
    return keys


def valid_of(which: str):
    rng = np.random.default_rng(9)
    if which == "none":
        return None
    if which == "dead":
        return np.zeros(N, bool)
    return rng.random(N) < 0.6


@pytest.mark.parametrize("valid", ["none", "mask", "dead"])
@pytest.mark.parametrize("kind", ["uniform", "heavy", "pad", "wide"])
@pytest.mark.parametrize("width", ["u32", "u64"])
def test_key_group_index_matches_jax(width, kind, valid):
    keys = keys_of(kind, width)
    v = valid_of(valid)
    want = jl.key_group_index(jnp.asarray(keys),
                              None if v is None else jnp.asarray(v))
    got = tl.key_group_index(carrier(keys),
                             None if v is None else torch.from_numpy(v))
    for f in GROUP_FIELDS:
        assert same(getattr(got, f), getattr(want, f)), f
    if valid == "dead":
        assert int(got.n_keys) == 0 and bool((got.gid_by_row == -1).all())


def test_emit_pos_matches_jax():
    rng = np.random.default_rng(5)
    length = rng.integers(1, 40, 2000).astype(np.int32)
    within = (rng.integers(0, 1 << 20, 2000) % length).astype(np.int32)
    got = tl.emit_pos(torch.from_numpy(within), torch.from_numpy(length))
    assert same(got, jl.emit_pos(jnp.asarray(within), jnp.asarray(length)))
    # slot 0 is the first row, then the rest from the last one down
    assert tl.emit_pos(torch.arange(4), torch.tensor(4)).tolist() == \
        [0, 3, 2, 1]


CHAINING_BUILDS = {
    # name: (valid, early_exit_index, key_domain, hashfun)
    "plain": ("none", True, None, "murmur"),
    "masked": ("mask", True, None, "murmur"),
    "no_ee": ("mask", False, None, "murmur"),
    "domain": ("none", True, 1 << 9, "murmur"),
    "identity": ("mask", True, None, "identity"),
    "dead": ("dead", True, None, "murmur"),
}


@pytest.mark.parametrize("build", list(CHAINING_BUILDS))
def test_build_chaining_matches_jax(build):
    valid, ee, dom, hf = CHAINING_BUILDS[build]
    keys = keys_of("pad" if build == "identity" else "uniform", "u32")
    v = valid_of(valid)
    nb = 97
    jt = jax_chaining(jnp.asarray(keys), nb,
                      valid=None if v is None else jnp.asarray(v),
                      key_domain=dom, hashfun=hf, early_exit_index=ee)
    names = [f for f in CHAINING_FIELDS + ("key_direct",)
             if field(jt, f) is not None]
    carried = chaining_table_from_numpy(fields_of(jt, names),
                                        num_buckets=nb, hashfun=hf,
                                        device="cpu")
    got = build_chaining(carrier(keys), nb,
                         valid=None if v is None else torch.from_numpy(v),
                         key_domain=dom, hashfun=hf, early_exit_index=ee)
    for f in names:
        assert torch.equal(field(got, f), field(carried, f)), f
    assert (got.key_direct is None) == (dom is None)
    assert got.group_min_pos.numel() == (N if ee else 0)


def test_dense_direct_builds_match_jax():
    rng = np.random.default_rng(6)
    perm = rng.permutation(N).astype(np.uint32)
    jt = jax_chaining(jnp.asarray(perm), N // 4, dense_direct=True)
    names = FIELDS + ("group_min_pos", "group_chain_first") + tuple(
        "groups." + f for f in GROUP_FIELDS)
    carried = chaining_table_from_numpy(fields_of(jt, names),
                                        num_buckets=N // 4, hashfun="murmur",
                                        device="cpu",
                                        direct_shift=jt.direct_shift)
    got = build_chaining(carrier(perm), N // 4, dense_direct=True)
    assert got.direct_shift == jt.direct_shift
    for f in names:
        assert torch.equal(field(got, f), field(carried, f)), f

    jt = jn.build_nested(jnp.asarray(perm), N // 4, dense_direct=True)
    names = NESTED_DENSE_FIELDS + ("main_pos_by_group",) + tuple(
        "groups." + f for f in GROUP_FIELDS)
    carried = nested_table_from_numpy(fields_of(jt, names),
                                      num_buckets=N // 4, hashfun="murmur",
                                      device="cpu",
                                      direct_shift=jt.direct_shift)
    got = build_nested(carrier(perm), N // 4, dense_direct=True)
    for f in names:
        assert torch.equal(field(got, f), field(carried, f)), f


@pytest.mark.parametrize("build", ["plain", "masked", "domain", "identity",
                                   "wide64", "dead"])
def test_build_nested_matches_jax(build):
    valid, _, dom, hf = CHAINING_BUILDS.get(build,
                                            ("mask", True, None, "murmur"))
    keys = keys_of("wide" if build == "wide64" else "heavy",
                   "u64" if build == "wide64" else "u32")
    v = valid_of(valid)
    nb = 61
    jt = jn.build_nested(jnp.asarray(keys), nb,
                         valid=None if v is None else jnp.asarray(v),
                         key_domain=dom, hashfun=hf)
    names = [f for f in NESTED_FIELDS if field(jt, f) is not None]
    carried = nested_table_from_numpy(fields_of(jt, names), num_buckets=nb,
                                      hashfun=hf, device="cpu")
    got = build_nested(carrier(keys), nb,
                       valid=None if v is None else torch.from_numpy(v),
                       key_domain=dom, hashfun=hf)
    for f in names:
        assert torch.equal(field(got, f), field(carried, f)), f


def _probe_keys(seed: int, n: int, hi: int):
    return np.random.default_rng(seed).integers(0, hi, n).astype(np.uint32)


@pytest.mark.parametrize("branch", ["positional", "compacted", "expanded",
                                    "expanded_at_p", "positional_at_p",
                                    "direct"])
def test_materialize_chaining_join_matches_jax(branch):
    """Each branch of ``materialize_chaining_join`` on a JAX-built table
    carried by ``convert.py``, the probe run on both sides: the four
    returned arrays bit-equal (``sync_free`` gives the same)."""
    if branch == "direct":
        keys = np.random.default_rng(8).permutation(N).astype(np.uint32)
        jt = jax_chaining(jnp.asarray(keys), N // 8, dense_direct=True)
        names = FIELDS + ("group_min_pos", "group_chain_first") + tuple(
            "groups." + f for f in GROUP_FIELDS)
    else:
        keys = keys_of("uniform" if branch != "positional_at_p" else "wide",
                       "u32")
        jt = jax_chaining(jnp.asarray(keys), 97)
        names = CHAINING_FIELDS
    table = chaining_table_from_numpy(
        fields_of(jt, names), num_buckets=jt.num_buckets, hashfun="murmur",
        device="cpu", direct_shift=jt.direct_shift)
    pk = _probe_keys(11, 3000, 1 << 10)
    if branch == "positional_at_p":
        pk[::2] = keys[:1500]
    unique = branch in ("positional", "compacted")
    jr = jax_probe_c(jt, jnp.asarray(pk), unique=unique)
    tr = probe_chaining(table, carrier(pk), unique=unique)
    assert int(tr.num_matches) == int(jr.num_matches)
    assert int(tr.num_cmps) == int(jr.num_cmps)
    P = pk.shape[0]
    out = {"positional": P, "compacted": int(jr.num_matches) + 7,
           "expanded": 1 << 14, "expanded_at_p": P, "positional_at_p": P,
           "direct": 2000}[branch]
    want = jax_mat(jt, jr, out, unique=unique)
    for sync_free in (False, True):
        got = materialize_chaining_join(table, tr, out, unique=unique,
                                        sync_free=sync_free)
        for g, w in zip(got, want):
            assert same(g, w)
    if branch == "expanded_at_p":
        assert int(tr.match_count.max()) > 1  # cut at P slots
    if branch == "positional_at_p":
        assert int(tr.match_count.max()) == 1


@pytest.mark.parametrize("branch", ["expanded", "direct_positional",
                                    "direct_expanded", "cut"])
def test_unnest_matches_jax(branch):
    if branch.startswith("direct"):
        keys = np.random.default_rng(12).permutation(N).astype(np.uint32)
        jt = jn.build_nested(jnp.asarray(keys), N // 8, dense_direct=True)
        names = NESTED_DENSE_FIELDS + ("main_pos_by_group",) + tuple(
            "groups." + f for f in GROUP_FIELDS)
    else:
        keys = keys_of("heavy", "u32")
        jt = jn.build_nested(jnp.asarray(keys), 61)
        names = [f for f in NESTED_FIELDS if field(jt, f) is not None]
    table = nested_table_from_numpy(
        fields_of(jt, names), num_buckets=jt.num_buckets, hashfun="murmur",
        device="cpu", direct_shift=jt.direct_shift)
    pk = _probe_keys(13, 2048, N + 500)
    mask = np.random.default_rng(14).random(2048) < 0.8
    jb = jn.probe_nested(jt, jnp.asarray(pk), mask=jnp.asarray(mask))
    tb = probe_nested(table, carrier(pk), mask=torch.from_numpy(mask))
    assert int(tb.num_cmps) == int(jb.num_cmps)
    assert (tb.direct_row is None) == (jb.direct_row is None)
    total = int(jnp.sum(jb.group_len))
    out = {"expanded": total + 9, "direct_positional": 2048,
           "direct_expanded": 4096, "cut": max(total // 2, 1)}[branch]
    want = jn.unnest(jt, jb, out)
    got = unnest(table, tb, out)
    for g, w in zip(got, want):
        assert same(g, w)


def test_deferred_two_join_strand_matches_jax():
    """exp-4's Ndu body on the JAX package's exp-4 data (R = 2^10), both
    tables JAX-built and carried over; a probe mask leaves rows out."""
    sa, ta = exp4_data(10, 2, 3, 3, 2)
    rk = np.arange(1 << 10, dtype=np.uint32)
    ndv = int(np.unique(sa).size)
    tables = []
    for col in (sa, ta):
        jt = jn.build_nested(jnp.asarray(col), ndv)
        names = [f for f in NESTED_FIELDS if field(jt, f) is not None]
        tables.append((jt, nested_table_from_numpy(
            fields_of(jt, names), num_buckets=ndv, hashfun="murmur",
            device="cpu")))
    mask = np.random.default_rng(15).random(rk.size) < 0.9
    out1, out2 = 1 << 11, 1 << 13
    want = jn.deferred_two_join_strand(tables[0][0], tables[1][0],
                                       jnp.asarray(rk), out1, out2,
                                       mask=jnp.asarray(mask))
    got = deferred_two_join_strand(tables[0][1], tables[1][1], carrier(rk),
                                   out1, out2, mask=torch.from_numpy(mask))
    assert set(got) == set(want)
    for k in want:
        assert same(got[k].reshape(np.asarray(want[k]).shape), want[k]), k
    triples = sorted(zip(*(got[k][got["valid"]].tolist()
                           for k in ("r_row", "s_row", "t_row"))))
    oracle = sorted((int(r), int(s), int(t)) for r in np.nonzero(mask)[0]
                    for s in np.nonzero(sa == rk[r])[0]
                    for t in np.nonzero(ta == rk[r])[0])
    assert triples == oracle


def _pairs(prow, brow, valid):
    return sorted((int(p), int(b)) for p, b, v in
                  zip(prow.tolist(), brow.tolist(), valid.tolist()) if v)


@pytest.mark.parametrize("case", range(len(workloads())))
def test_chaining_vs_oracle(case):
    bk, pk, nb = workloads()[case]
    oracle = ChainingOracle(bk, nb)
    tbl = build_chaining(carrier(bk), nb)
    blen = tbl.bucket_len.numpy()
    pos = tbl.pos_by_row.numpy()
    for b in range(nb):
        chain = oracle.chain(b)
        assert blen[b] == len(chain)
        for want_pos, (row, _) in enumerate(chain):
            assert pos[row] == want_pos, (b, row)
    for unique in (False, True):
        opairs, omatches, ocmps = oracle.probe(pk, unique=unique)
        for method in ("search", "merge"):
            pr = probe_chaining(tbl, carrier(pk), unique=unique,
                                method=method)
            assert int(pr.num_matches) == omatches
            assert int(pr.num_cmps) == ocmps
        out = materialize_chaining_join(tbl, pr, max(len(opairs) + 3, 8),
                                        unique=unique)
        assert int(out[3]) == len(opairs)
        assert _pairs(*out[:3]) == sorted(opairs)


@pytest.mark.parametrize("case", range(len(workloads())))
def test_nested_vs_oracle(case):
    bk, pk, nb = workloads()[case]
    oracle = NestedOracle(bk, nb)
    tbl = build_nested(carrier(bk), nb)
    bml = tbl.bucket_main_len.numpy()
    for b in range(nb):
        assert bml[b] == len(oracle.buckets.get(b, []))
    nkeys = int(tbl.groups.n_keys)
    ukey = tbl.groups.ukey.numpy().view(np.uint32)
    mpos = tbl.main_pos_by_group.numpy()
    got_pos = {int(ukey[g]): int(mpos[g]) for g in range(nkeys)}
    for mains in oracle.buckets.values():
        for want_pos, m in enumerate(mains):
            assert got_pos[m["key"]] == want_pos
    onested, omatches, ocmps = oracle.probe(pk)
    for method in ("search", "merge"):
        nbatch = probe_nested(tbl, carrier(pk), method=method)
        assert int(nbatch.num_matches) == omatches
        assert int(nbatch.num_cmps) == ocmps
    oout = NestedOracle.unnest(onested)
    prow, brow, valid, total = unnest(tbl, nbatch, max(len(oout) + 3, 8))
    assert int(total) == len(oout)
    assert _pairs(prow, brow, valid) == sorted(oout)
    # the unnest ORDER per probe row: [first inserted, the rest LIFO]
    got_by_probe, want_by_probe = {}, {}
    for p, r, v in zip(prow.tolist(), brow.tolist(), valid.tolist()):
        if v:
            got_by_probe.setdefault(p, []).append(r)
    for p, r in oout:
        want_by_probe.setdefault(p, []).append(r)
    assert got_by_probe == want_by_probe
