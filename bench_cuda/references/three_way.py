"""Two joins R |><| S |><| T with deferred unnesting (exp-4's Ndu): nested
tables on S and on T, probed by every row of R; the T probe runs only for
the R rows that hit S.

Counters, with the artifact's names in brackets: ``rs`` / ``rs_cmp``
[c_probe_RS(_cmp)], ``rt`` / ``rt_cmp`` [c_probe_RT(_cmp)], ``unnest_t``
[c_unnest_1], the (r, t) pairs of the rows that hit both, and ``total``
[c_unnest_2 = c_top], the result triples.  The triples (``r_row``,
``s_row``, ``t_row``; -1 in unused slots) are judged by what they say:
each names rows of one key on all three sides, none comes twice, and as
many come as the join has.
"""

from __future__ import annotations

import torch

from ..refcore import (I64, bucket, distinct_count, nested_chains,
                       probe_cmps, u32)
from .two_way import truncate

COUNTERS = ("rs", "rs_cmp", "rt", "rt_cmp", "unnest_t", "total")
LIMITS = {"rows_bad": 0, "rows_dup": 0, "rows_gap": 0,
          **{f"{c}_gap": 0 for c in COUNTERS}}


def expect(cols, config, traffic) -> dict:
    r, s, t = (u32(cols[k]) for k in ("R", "S", "T"))
    domain = int(max(r.max(), s.max(), t.max())) + 1
    tables = []
    for col in (s, t):
        nb = max(int(torch.unique(col).numel()) // int(config.get("b", 1)),
                 1)

        def chain(k, nb=nb):
            return bucket(k, nb)

        pos, rows, clen = nested_chains(col, chain, nb, domain)
        tables.append((pos, rows, clen, chain))
    (pos_s, rows_s, clen_s, ch_s), (pos_t, rows_t, clen_t, ch_t) = tables
    hit_s, rs, rs_cmp = probe_cmps(pos_s, clen_s, r, ch_s, domain)
    both, rt, rt_cmp = probe_cmps(pos_t, clen_t, r, ch_t, domain,
                                  live=hit_s)
    rb = r[both]
    return dict(rs=rs, rs_cmp=rs_cmp, rt=rt, rt_cmp=rt_cmp,
                unnest_t=int(rows_t[rb].sum()),
                total=int((rows_s[rb] * rows_t[rb]).sum()))


def judge(cols, kept, expected, traffic) -> dict:
    r, s, t = (u32(cols[k]) for k in ("R", "S", "T"))
    rows = [kept[k].to(I64) for k in ("r_row", "s_row", "t_row")]
    live = [x >= 0 for x in rows]
    v = live[0] & live[1] & live[2]
    bad = int(((live[0] | live[1] | live[2]) & ~v).sum())
    rr, sr, tr = (x[v] for x in rows)
    inside = (rr < r.numel()) & (sr < s.numel()) & (tr < t.numel())
    bad += int((~inside).sum())
    rr, sr, tr = rr[inside], sr[inside], tr[inside]
    bad += int(((r[rr] != s[sr]) | (r[rr] != t[tr])).sum())
    # a valid triple's r is the one R row of its key (R.k is unique), so
    # (s, t) names the triple
    _, dup = distinct_count(sr * t.numel() + tr)
    out = dict(rows_bad=bad, rows_dup=dup,
               rows_gap=abs(int(v.sum()) - expected["total"]))
    for name in COUNTERS:
        out[f"{name}_gap"] = abs(int(kept["counters"][name]) - expected[name])
    return out


def control(cols, config, traffic, expected) -> dict:
    """The reference on u16 keys: every exact triple stays, the truncated
    matches add to them."""
    c = expect(truncate(cols), config, traffic)
    out = dict(rows_bad=c["total"] - expected["total"], rows_dup=0,
               rows_gap=abs(c["total"] - expected["total"]))
    for name in COUNTERS:
        out[f"{name}_gap"] = abs(c[name] - expected[name])
    return out
