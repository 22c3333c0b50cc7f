"""``hashjoin3d_tpu_torch.join``'s modes, predicates, hash functors,
empty sides and mixed key widths on the CPU against
``hashjoin3d_tpu.join(backend="device")``.

Same seeded numpy inputs on both sides (``tests/test_torch_api.py``'s key
kinds), exact equality (integer work: the tolerance is zero): counters
bit-equal, result pairs equal as multisets, for

* the modes left, semi and anti on dense-domain u32 and on u64 keys (semi
  is exactly the inner join's probe rows, anti their complement);
* ``predicate_mode`` "post" and "inchain" with payload columns, each with
  the modes inner, left and anti; "post" equals numpy's filter of the
  inner pairs;
* every registry hash functor and a callable, each on one physical path;
* empty sides in every mode, and ``JoinResult.take``;
* the mixed-width rule: a u32 build probed with u64 keys gives the all-u64
  join of the widened columns (the JAX package hashes such a probe with
  murmur64 against a murmur32 table, ROADMAP Queue 3).
"""

import numpy as np
import pytest

import hashjoin3d_tpu as jhj

import hashjoin3d_tpu_torch as thj

from test_torch_api import HOWS, N, P, columns, same_result


@pytest.mark.parametrize("mode", ["left", "semi", "anti"])
@pytest.mark.parametrize("how,unique", HOWS)
def test_modes_match_jax(how, unique, mode):
    for kind in ("u32_dense", "u64"):
        bk, pk = columns(kind)
        want = jhj.join(bk, pk, how=how, unique=unique, mode=mode,
                        backend="device")
        got = thj.join(bk, pk, how=how, unique=unique, mode=mode,
                       device="cpu")
        same_result(got, want, f"{kind} {mode}")
        inner = thj.join(bk, pk, how=how, unique=unique, device="cpu")
        hit_rows = np.unique(inner.probe_rows)
        if mode == "semi":
            assert np.array_equal(got.probe_rows, hit_rows)
        elif mode == "anti":
            assert np.array_equal(got.probe_rows,
                                  np.setdiff1d(np.arange(P), hit_rows))
        if mode != "left":
            assert (got.build_rows == -1).all()
            assert (got.num_matches, got.num_cmps) == (inner.num_matches,
                                                       inner.num_cmps)


def payloads(kind):
    bk, pk = columns(kind)
    rng = np.random.default_rng(2)
    return (bk, pk, {"v": rng.integers(0, 100, pk.size)},
            {"v": rng.integers(0, 100, bk.size)})


def odd_sum(p, b):
    return (p["v"] + b["v"]) % 2 == 1


@pytest.mark.parametrize("predicate_mode", ["post", "inchain"])
@pytest.mark.parametrize("how,unique", HOWS)
def test_predicates_match_jax(how, unique, predicate_mode):
    for kind in ("u32_dense", "u64"):
        bk, pk, pp, bp = payloads(kind)
        for mode in ("inner", "left", "anti"):
            kw = dict(how=how, unique=unique, mode=mode, predicate=odd_sum,
                      predicate_mode=predicate_mode, probe_payload=pp,
                      build_payload=bp)
            want = jhj.join(bk, pk, backend="device", **kw)
            got = thj.join(bk, pk, device="cpu", **kw)
            same_result(got, want, f"{kind} {mode} {predicate_mode}")
    bk, pk, pp, bp = payloads("u32_dense")
    got = thj.join(bk, pk, how=how, unique=unique, device="cpu")
    post = thj.join(bk, pk, how=how, unique=unique, predicate=odd_sum,
                    probe_payload=pp, build_payload=bp, device="cpu")
    keep = (pp["v"][got.probe_rows] + bp["v"][got.build_rows]) % 2 == 1
    assert sorted(post.pairs()) == sorted(
        zip(got.probe_rows[keep].tolist(), got.build_rows[keep].tolist()))


#: each functor on one physical path: key_direct nested, merged chaining,
#: dense-direct chaining with the early exit, merged nested (composite
#: keys), key_direct chaining with the early exit
FUNCTOR_CASES = [("boncz", "u32_dense", "nested", False),
                 ("fib", "u64", "chaining", False),
                 ("mult", "u32_perm", "chaining", True),
                 ("identity", "composite", "nested", False),
                 ("callable", "u32_dense", "chaining", True)]


@pytest.mark.parametrize("hashfun,kind,how,unique", FUNCTOR_CASES)
def test_hash_functors_match_jax(hashfun, kind, how, unique):
    fn = (lambda k: k * 3 + 1) if hashfun == "callable" else hashfun
    bk, pk = columns(kind)
    want = jhj.join(bk, pk, how=how, unique=unique, hashfun=fn,
                    backend="device")
    got = thj.join(bk, pk, how=how, unique=unique, hashfun=fn, device="cpu")
    same_result(got, want, f"{kind} {how} {hashfun}")


def test_empty_sides_and_take_match_jax():
    bk, pk = columns("u32_dense")
    none = np.zeros(0, np.uint32)
    for b, p in ((none, pk), (bk, none), (none, none)):
        for mode in ("inner", "left", "semi", "anti"):
            same_result(thj.join(b, p, mode=mode, device="cpu"),
                        jhj.join(b, p, mode=mode, backend="device"), mode)
    res = thj.join(bk, pk, how="chaining", mode="left", device="cpu")
    want = jhj.join(bk, pk, how="chaining", mode="left", backend="device")
    order = np.lexsort((res.build_rows, res.probe_rows))
    worder = np.lexsort((want.build_rows, want.probe_rows))
    pcol = {"p": np.arange(P) * 10}
    bcol = {"b": np.arange(N, dtype=np.int16) + 1}
    got_t, want_t = res.take(pcol, bcol), want.take(pcol, bcol)
    for k in ("p", "b"):
        assert got_t[k].dtype == want_t[k].dtype
        assert np.array_equal(got_t[k][order], want_t[k][worder])
    assert (got_t["b"][res.build_rows < 0] == 0).all()
    empty = thj.join(none, pk, mode="left", device="cpu")
    assert (empty.take(build_cols={"b": np.zeros(0, np.int8)})["b"]
            == 0).all()


def test_mixed_widths_join_the_widened_columns():
    """A u32 build probed with u64 keys (and the reverse) equals the
    all-u64 join of the zero-extended columns, held against the JAX
    package's all-u64 join; ROADMAP Queue 3 records the JAX package's
    different counts for the mixed call itself."""
    bk, pk = columns("u32_dense")
    pk64 = pk.astype(np.uint64)
    pk64[:5] = np.uint64(2**32) + pk64[:5]   # probes no u32 key can equal
    bk64 = bk.astype(np.uint64)
    same_result(thj.join(bk, pk64, device="cpu"),
                jhj.join(bk64, pk64, backend="device"), "nested")
    for how, unique in HOWS:
        wide = thj.join(bk64, pk64, how=how, unique=unique, device="cpu")
        same_result(thj.join(bk, pk64, how=how, unique=unique,
                             device="cpu"), wide, f"u32 build {how}")
        same_result(thj.join(pk64, bk, how=how, unique=unique,
                             device="cpu"),
                    thj.join(pk64, bk64, how=how, unique=unique,
                             device="cpu"), f"u64 build {how}")
    # a signed i32 column widens from its u32 bits, never sign-extends
    neg = np.array([-1, 5], np.int32)
    res = thj.join(neg, np.array([2**32 - 1, 2**64 - 1, 5], np.uint64),
                   device="cpu")
    assert sorted(res.pairs()) == [(0, 0), (2, 1)]
