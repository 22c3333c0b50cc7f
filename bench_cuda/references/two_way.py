"""One hash join of two relations: a table built on ``table.build`` and
probed by every row of ``table.probe`` (exp-1's Csr, Crs and Nrs, and the
distributed Nrs on ``shards`` ranks).

Counters, with the artifact's names in brackets: ``matches``
[c_htProbe]; ``cmps`` [c_htProbeCmp], nodes compared; ``total`` [c_top /
c_unnest], result pairs.  A probe that misses compares its whole chain.
A chaining table with ``early_exit`` (Csr: unique build keys) counts a
probe that finds its key as one match of ``pos + 1`` compared nodes and
emits one pair.  One without it (Crs; ``algebra.hh:640-658`` without
``IsBuildKeyUnique``) walks every probe's whole chain, and every build
row of the key is a match and a pair.  A nested table counts a probe
that finds its key's main node as one match of ``pos + 1`` nodes and
emits every build row of the key.  The pair rows (``probe_row``,
``build_row``; -1 in unused slots) are judged by what they say: each
names a probe row and a build row of equal keys, no pair comes twice,
and as many come as the join has.
"""

from __future__ import annotations

import torch

from ..refcore import (I64, bucket, chaining_chains, distinct_count,
                       nested_chains, probe_cmps, u32)

COUNTERS = ("matches", "cmps", "total")
LIMITS = {"rows_bad": 0, "rows_dup": 0, "rows_gap": 0, "matches_gap": 0,
          "cmps_gap": 0, "total_gap": 0}


def buckets(cols, config, traffic) -> int:
    """The table's bucket count: ``config.buckets_per_shard`` on a mesh,
    else the build side's rows or distinct keys over ``config.b``."""
    t = traffic["table"]
    if t["buckets"] == "config":
        return int(config["buckets_per_shard"])
    keys = u32(cols[t["build"]])
    n = (keys.numel() if t["buckets"] == "build_rows"
         else int(torch.unique(keys).numel()))
    return max(n // int(config.get("b", 1)), 1)


def _table(cols, config, traffic):
    t = traffic["table"]
    bk, pk = u32(cols[t["build"]]), u32(cols[t["probe"]])
    domain = int(max(bk.max(), pk.max())) + 1
    nb = buckets(cols, config, traffic)
    shards = int(config.get("ranks", 1))

    def chain(k):
        return bucket(k, nb, shards)

    if t["kind"] == "chaining":
        pos, rows, first_row, clen = chaining_chains(bk, chain(bk), nb * shards,
                                                     domain)
    else:
        pos, rows, clen = nested_chains(bk, chain, nb * shards, domain)
        first_row = None
    hit, matches, cmps = probe_cmps(pos, clen, pk, chain, domain)
    total = int(rows[pk[hit]].sum())
    if t["kind"] == "chaining":
        if t["early_exit"]:
            total = matches
        else:
            matches, cmps = total, int(clen[chain(pk)].sum())
    return dict(bk=bk, pk=pk, hit=hit, first_row=first_row,
                counters=dict(matches=matches, cmps=cmps, total=total))


def expect(cols, config, traffic) -> dict:
    return _table(cols, config, traffic)["counters"]


def judge(cols, kept, expected, traffic) -> dict:
    """The numbers of one query: ``kept`` holds its ``probe_row`` and
    ``build_row`` (on the columns' device) and its host ``counters``."""
    t = traffic["table"]
    bk, pk = u32(cols[t["build"]]), u32(cols[t["probe"]])
    pr, br = kept["probe_row"].to(I64), kept["build_row"].to(I64)
    pv, bv = pr >= 0, br >= 0
    bad = int((pv != bv).sum())
    v = pv & bv
    pr, br = pr[v], br[v]
    inside = (pr < pk.numel()) & (br < bk.numel())
    bad += int((~inside).sum())
    pr, br = pr[inside], br[inside]
    bad += int((pk[pr] != bk[br]).sum())
    _, dup = distinct_count(pr * bk.numel() + br)
    out = dict(rows_bad=bad, rows_dup=dup,
               rows_gap=abs(int(v.sum()) - expected["total"]))
    for name in COUNTERS:
        out[f"{name}_gap"] = abs(int(kept["counters"][name]) - expected[name])
    return out


def truncate(cols) -> dict:
    """The columns at the next lower key width: u16."""
    return {k: v & 0xFFFF for k, v in cols.items()}


def control(cols, config, traffic, expected) -> dict:
    """The reference on u16 keys in the program's place, judged on the
    u32 keys: an early-exit probe emits its truncated key's first row in
    chain order; otherwise every exact pair stays and the truncated
    matches add to them."""
    low = _table(truncate(cols), config, traffic)
    c = low["counters"]
    if low["first_row"] is not None and traffic["table"]["early_exit"]:
        t = traffic["table"]
        bk, pk = u32(cols[t["build"]]), u32(cols[t["probe"]])
        chosen = low["first_row"][low["pk"][low["hit"]]]
        bad = int((bk[chosen] != pk[low["hit"]]).sum())
    else:
        bad = c["total"] - expected["total"]
    out = dict(rows_bad=bad, rows_dup=0,
               rows_gap=abs(c["total"] - expected["total"]))
    for name in COUNTERS:
        out[f"{name}_gap"] = abs(c[name] - expected[name])
    return out
