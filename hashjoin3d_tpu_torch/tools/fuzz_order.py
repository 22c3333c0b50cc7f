"""Randomized fuzz of the clarity ops' exact per-group emission order.

Port of ``tools/fuzz_order.py``.  Random tables (both kinds, the clarity
builds and the compacted builds, build hints, both nested probe methods)
and, per probe row, the exact emitted build-row sequence:

- nested ``unnest``: [first-inserted, rest LIFO], the reference's
  MainNode-then-subchain walk (``ht_nested.hh:398-412``);
- chaining ``materialize_chaining_join`` with ``unique=True``: the single
  emitted row is the first match in bucket-chain order (``algebra.hh:
  625-659`` early exit);
- chaining with ``unique=False``: the engine's convention, each key group
  emits [first-inserted, rest LIFO] (``layout.emit_pos``).

Counters (c_htProbe / c_htProbeCmp) are checked in every trial.

* small tier: the JAX fuzzer's draws (``tools/fuzz_order.py:51-150``, same
  seed, same cases), ground truth the insertion-simulating oracle
  (:mod:`.oracle`);
* large tier: up to 2^20 build and probe rows (ragged), bounded
  duplicates; ground truth the native host engine, whose walk emits each
  probe's rows in chain order (the first two rules), and numpy's key
  groups (the third).

    python3 -m hashjoin3d_tpu_torch.tools.fuzz_order [--trials N]
        [--seed S] [--tier small|large|both] [--device cuda|cpu]
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..hostengine import host_chaining_join, host_nested_join
from ..ops.chaining import (build_chaining, build_chaining_host,
                            materialize_chaining_join, probe_chaining)
from ..ops.layout import key_column
from ..ops.nested import (build_nested, build_nested_host, probe_nested,
                          unnest)
from .fuzzing import (Tier, bounds, log_uniform, main, merge_reach, ragged,
                      require, run_tiers)
from .oracle import ChainingOracle, NestedOracle

#: the large tier's sizes (log2 rows)
LARGE_ROWS = (16, 20)
#: rows of the large tier's hot key on the build side
HOT_ROWS = 64


def config(c) -> str:
    cfg = (f"trial {c.trial}: {c.how}/{c.builder} nb={c.bk.size} "
           f"np={c.pk.size} dom={c.dom} bkt={c.nbkt} hints={sorted(c.kw)}")
    if c.how == "nested":
        return cfg + f" method={c.method}"
    return cfg + f" unique={c.unique} out={c.out_kind}"


def small_case(rng, trial, cut=None):
    """One trial's draws, in ``tools/fuzz_order.py:62-150``'s order.  Two
    of them size an output buffer from the result (the unnest's and the
    chaining expansion's slack past the match count); they are kept as
    drawn and applied when the trial runs."""
    n_b = int(rng.integers(1, 1500))
    n_p = int(rng.integers(1, 2500))
    dom = int(rng.integers(2, 3 * max(n_b, 4)))
    bk = rng.integers(0, dom, n_b, dtype=np.uint32)
    pk = rng.integers(0, dom + dom // 4 + 1, n_p, dtype=np.uint32)
    if rng.random() < 0.3:  # heavy duplicates
        bk[: n_b // 2] = bk[0]
        pk[: n_p // 3] = bk[0]
    ndv = int(np.unique(bk).size)
    nbkt = int(rng.integers(1, 2 * ndv + 2))
    how = str(rng.choice(["nested", "chaining"]))
    builder = str(rng.choice(["padded", "host"]))
    kw = {}
    if builder == "host":
        if rng.random() < 0.5:
            kw["n_keys"] = ndv
        if rng.random() < 0.5:
            kw["key_domain"] = dom + dom // 4 + 1
    case = SimpleNamespace(trial=trial, bk=bk, pk=pk, dom=dom, nbkt=nbkt,
                           how=how, builder=builder, kw=kw)
    if how == "nested":
        case.method = str(rng.choice(["default", "merge"]))
        case.slack = int(rng.integers(0, 8))
    else:
        case.unique = bool(rng.random() < 0.5)
        # "probes": out_size = n_p; else the match count plus the slack
        case.out_kind = "probes" if rng.random() < 0.5 else "matches"
        case.slack = (int(rng.integers(0, 8)) if case.out_kind == "matches"
                      else 0)
    case.cfg = config(case)
    return case


def sequences(prow, brow, valid=None) -> tuple:
    """Emission as ``(probe rows, build rows)`` ordered by probe row, each
    row's build rows in emitted order (a stable sort keeps it)."""
    prow = np.asarray(prow, np.int64)
    brow = np.asarray(brow, np.int64)
    if valid is not None:
        v = np.asarray(valid, bool)
        prow, brow = prow[v], brow[v]
    order = np.argsort(prow, kind="stable")
    return prow[order], brow[order]


def list_sequences(pairs) -> tuple:
    a = np.asarray(pairs, np.int64).reshape(-1, 2)
    return sequences(a[:, 0], a[:, 1])


def group_emission(bk, pk) -> tuple:
    """Each probe's key group as [first-inserted, rest LIFO]
    (``layout.emit_pos``): the chaining convention without ``unique``."""
    order = np.argsort(bk, kind="stable")
    sk = bk[order]
    start = np.searchsorted(sk, pk, side="left")
    length = np.searchsorted(sk, pk, side="right") - start
    gs = np.searchsorted(sk, sk, side="left")
    glen = np.searchsorted(sk, sk, side="right") - gs
    j = np.arange(bk.size) - gs
    emit = np.where(j == 0, 0, glen - j)  # arrival j -> emission slot
    rows = np.empty(bk.size, np.int64)
    rows[gs + emit] = order
    prow = np.repeat(np.arange(pk.size), length)
    first = np.repeat(start, length)
    within = np.arange(prow.size) - np.repeat(np.cumsum(length) - length,
                                              length)
    return prow, rows[first + within]


def run_case(case, dev):
    """The port's clarity ops on ``dev``: (matches, cmps, total, emission
    sequences)."""
    bk, pk = key_column(case.bk, dev), key_column(case.pk, dev)
    if case.how == "nested":
        tbl = (build_nested(bk, case.nbkt) if case.builder == "padded"
               else build_nested_host(bk, case.nbkt, **case.kw))
        res = probe_nested(tbl, pk, method="merge" if case.method == "merge"
                           else "auto")
        total = int(res.group_len.sum(dtype=torch.int64))
        prow, brow, valid, tot = unnest(tbl, res, max(total, 1) + case.slack)
    else:
        tbl = (build_chaining(bk, case.nbkt) if case.builder == "padded"
               else build_chaining_host(bk, case.nbkt, **case.kw))
        res = probe_chaining(tbl, pk, unique=case.unique)
        matches = int(res.num_matches)
        out_size = (pk.shape[0] if case.out_kind == "probes"
                    else max(matches, 1) + case.slack)
        prow, brow, valid, tot = materialize_chaining_join(
            tbl, res, max(out_size, matches), unique=case.unique)
    return (int(res.num_matches), int(res.num_cmps), int(tot),
            sequences(prow.cpu().numpy(), brow.cpu().numpy(),
                      valid.cpu().numpy()))


def compare(case, got, matches, cmps, want) -> None:
    m, c, tot, (gp, gb) = got
    wp, wb = want
    require(m == matches, case.cfg, "matches", m, matches)
    require(c == cmps, case.cfg, "cmps", c, cmps)
    require(tot == wp.size, case.cfg, "total", tot, wp.size)
    rule = ("unnest order" if case.how == "nested"
            else "unique chain-first" if case.unique else "group emit order")
    require(np.array_equal(gp, wp) and np.array_equal(gb, wb), case.cfg,
            rule)


def check_small(case, dev) -> str:
    if case.how == "nested":
        orc = NestedOracle(case.bk, case.nbkt)
        nested, matches, cmps = orc.probe(case.pk)
        want = list_sequences(NestedOracle.unnest(nested))
    else:
        pairs, matches, cmps = ChainingOracle(case.bk, case.nbkt).probe(
            case.pk, unique=case.unique)
        want = (list_sequences(pairs) if case.unique
                else group_emission(case.bk, case.pk))
    compare(case, run_case(case, dev), matches, cmps, want)
    return ""


def large_case(rng, trial, cut=None):
    """Draws at the large tier's sizes (``cut`` caps the columns at 2^cut
    rows): u32 keys over a domain of n_b / 4 to 2 n_b, a hot key on at
    most :data:`HOT_ROWS` build rows, at least ndv / 4 buckets."""
    lo, hi = bounds(LARGE_ROWS, cut)
    n_b = ragged(log_uniform(rng, lo, hi))
    n_p = ragged(log_uniform(rng, lo, hi))
    dom = max(2, int(n_b * 2 ** rng.uniform(-2, 1)))
    bk = rng.integers(0, dom, n_b, dtype=np.uint32)
    pk = rng.integers(0, dom + dom // 4 + 1, n_p, dtype=np.uint32)
    if rng.random() < 0.3:  # a hot key, bounded
        bk[rng.choice(n_b, min(HOT_ROWS, n_b // 2), replace=False)] = bk[0]
        pk[rng.choice(n_p, n_p // 8, replace=False)] = bk[0]
    ndv = int(np.unique(bk).size)
    nbkt = int(rng.integers(max(1, ndv // 4), 2 * ndv + 2))
    how = str(rng.choice(["nested", "chaining"]))
    builder = str(rng.choice(["padded", "host"]))
    kw = {}
    if builder == "host":
        if rng.random() < 0.5:
            kw["n_keys"] = ndv
        if rng.random() < 0.5:
            kw["key_domain"] = dom + dom // 4 + 1
    case = SimpleNamespace(trial=trial, bk=bk, pk=pk, dom=dom, nbkt=nbkt,
                           how=how, builder=builder, kw=kw)
    if how == "nested":
        case.method = str(rng.choice(["default", "merge"]))
        case.slack = int(rng.integers(0, 8))
    else:
        case.unique = bool(rng.random() < 0.5)
        case.out_kind = "probes" if rng.random() < 0.5 else "matches"
        case.slack = int(rng.integers(0, 8))
    case.cfg = config(case)
    return case


def check_large(case, dev) -> str:
    """The clarity ops against the host engine's walk order."""
    if case.how == "nested":
        op, ob, matches, cmps, _ = host_nested_join(case.bk, case.pk,
                                                    case.nbkt)
        want = sequences(op, ob)
    else:
        op, ob, matches, cmps = host_chaining_join(
            case.bk, case.pk, case.nbkt, unique=case.unique)
        want = (sequences(op, ob) if case.unique
                else group_emission(case.bk, case.pk))
    compare(case, run_case(case, dev), matches, cmps, want)
    return f" emitted={want[0].size}"


def large_reach(cases) -> dict:
    """K3: the builds' run structure over the build rows and the
    expansion's scan over the probe rows (K1 and K4 are not on this
    path)."""
    return merge_reach({"k3": max(c.bk.size, c.pk.size)} for c in cases)


TIERS = {"small": Tier(40, small_case, check_small),
         "large": Tier(4, large_case, check_large, large_reach, ("k3",))}


def run(dev, trials, seed, tier, log, cut=None) -> dict:
    """``trials`` (None: 40 small, 4 large) of ``tier`` on ``dev``."""
    return run_tiers("fuzz_order", TIERS, dev, trials, seed, tier, log, cut)


if __name__ == "__main__":
    raise SystemExit(main("fuzz_order", run, __doc__))
