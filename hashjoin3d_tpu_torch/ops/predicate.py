"""In-chain predicate evaluation: counter parity with the reference walk.

Port of ``hashjoin3d_tpu/ops/predicate.py``, a host-side numpy simulation
over the port's own ``hash_key_np``.  ``api.join(predicate_mode="post")``
post-filters hash-equality matches; the reference instead evaluates the
join predicate inside the chain walk:

* chaining (``algebra.hh:625-659``): every chain node costs a comparison;
  a node matches iff its stored hashvalue equals the probe's and
  ``joinpred_t::eval(probe, node.data())`` holds.  With
  ``IsBuildKeyUnique`` the walk breaks at the first such node, so
  ``c_htProbeCmp`` depends on the predicate; without it the whole chain is
  walked regardless.
* nested (``ht_nested.hh:354-382``, ``algebra.hh:430-459``): the main chain
  is walked with one comparison per distinct-key node and stops at the
  first node with an equal hashvalue that passes the predicate, evaluated
  once per distinct key against the group's first tuple; a match emits the
  whole group.

The simulation reproduces those counters exactly for any predicate over
the reference's chain-order model: rows hash to ``bucket = hashvalue %
num_buckets``; a bucket's chain is [first-inserted row, then later rows in
LIFO order]; nested main nodes append in first-occurrence order with LIFO
subchains.  The predicate is a host callable, so the walk runs on the host.
"""

from __future__ import annotations

import numpy as np

from .hashing import hash_key_np

__all__ = ["chaining_inchain_probe", "nested_inchain_probe"]


def _chain_positions(hv: np.ndarray, num_buckets: int):
    """Per-row chain position (0-based) + per-bucket chain length under the
    reference chain order (``ht_chaining.hh``: the first row of a bucket is
    the directory node; later rows head-insert right after it, so the chain
    reads [first, last, ..., second])."""
    b = (hv % np.asarray(num_buckets, hv.dtype)).astype(np.int64)
    n = b.size
    order = np.argsort(b, kind="stable")          # rows grouped by bucket
    bs = b[order]
    is_first = np.empty(n, bool)
    is_first[:1] = True
    is_first[1:] = bs[1:] != bs[:-1]
    # occurrence index of each row within its bucket (insertion order)
    occ_sorted = np.arange(n) - np.maximum.accumulate(
        np.where(is_first, np.arange(n), -1))
    occ = np.empty(n, np.int64)
    occ[order] = occ_sorted
    blen = np.bincount(b, minlength=num_buckets)
    cnt = blen[b]
    pos = np.where(occ == 0, 0, cnt - occ)
    return pos, blen


def _hash_equal_candidates(hv_b: np.ndarray, hv_p: np.ndarray):
    """All (probe_idx, build_idx) pairs with equal hashvalues (the
    reference's candidate gate ``node.hashvalue() == probeHash``), build
    side enumerated in insertion order within each hash class."""
    sb = np.argsort(hv_b, kind="stable")
    hs = hv_b[sb]
    uh, ustart = np.unique(hs, return_index=True)
    ucnt = np.diff(np.append(ustart, hs.size))
    j = np.searchsorted(uh, hv_p)
    j = np.clip(j, 0, max(uh.size - 1, 0))
    hit = (uh.size > 0) & (uh[j] == hv_p) if uh.size else np.zeros(
        hv_p.size, bool)
    cnt_p = np.where(hit, ucnt[j], 0)
    p_idx = np.repeat(np.arange(hv_p.size), cnt_p)
    csum = np.cumsum(cnt_p) - cnt_p
    within = np.arange(int(cnt_p.sum())) - np.repeat(csum, cnt_p)
    b_idx = sb[ustart[j][p_idx] + within]
    return p_idx.astype(np.int64), b_idx.astype(np.int64)


def chaining_inchain_probe(bk, pk, num_buckets: int, unique: bool,
                           evaluate, hashfun="murmur"):
    """Reference-exact chaining probe with the predicate in the walk.

    ``evaluate(probe_rows, build_rows) -> bool array`` is the join
    predicate over candidate row-id pairs.  Returns ``(probe_rows,
    build_rows, num_matches, num_cmps)`` with the counters of
    ``algebra.hh:625-659``:

    * ``unique=False``: every probe whose bucket is non-empty walks the
      WHOLE chain (no break), so cmps are predicate-independent; matches
      are the (hashvalue-equal AND predicate) nodes.
    * ``unique=True`` (IsBuildKeyUnique): the walk breaks at the first
      passing node -- cmps = its 1-based chain position, or the full chain
      length when nothing passes; at most one pair emits per probe.
    """
    hv_b = hash_key_np(np.asarray(bk), hashfun)
    hv_p = hash_key_np(np.asarray(pk), hashfun)
    pos, blen = _chain_positions(hv_b, num_buckets)
    bucket_p = (hv_p % np.asarray(num_buckets, hv_p.dtype)).astype(np.int64)
    p_idx, b_idx = _hash_equal_candidates(hv_b, hv_p)
    keep = np.asarray(evaluate(p_idx, b_idx), bool)

    if not unique:
        cmps = int(blen[bucket_p].sum())      # empty bucket walks 0 nodes
        prow, brow = p_idx[keep], b_idx[keep]
        return (prow.astype(np.int32), brow.astype(np.int32),
                int(prow.size), cmps)

    INF = np.int64(1) << 62
    cand_pos = np.where(keep, pos[b_idx], INF)
    best = np.full(hv_p.size, INF, np.int64)
    np.minimum.at(best, p_idx, cand_pos)
    found = best < INF
    cmps = int(np.where(found, best + 1, blen[bucket_p]).sum())
    # the emitted pair is the argmin node (chain positions are unique
    # within a bucket, so the mask picks exactly one row per found probe)
    emit = keep & (pos[b_idx] == best[p_idx])
    prow, brow = p_idx[emit], b_idx[emit]
    return (prow.astype(np.int32), brow.astype(np.int32),
            int(prow.size), cmps)


def nested_inchain_probe(bk, pk, num_buckets: int, evaluate,
                         hashfun="murmur"):
    """Reference-exact nested probe with the predicate in the main walk.

    ``evaluate(probe_rows, group_first_rows) -> bool array`` is the join
    predicate, evaluated ONCE per (probe, distinct-key main node) candidate
    against the group's first tuple (``ht_nested.hh:354-382``).  Returns
    ``(probe_rows, build_rows, num_matches, num_cmps, num_results)`` where
    the pairs expand each matched probe's whole group in the reference's
    [first, rest LIFO] emission order and cmps stop at the first passing
    main node (full main-chain length on a walk with no match).
    """
    bk = np.asarray(bk)
    hv_b = hash_key_np(bk, hashfun)
    hv_p = hash_key_np(np.asarray(pk), hashfun)

    # distinct keys in first-occurrence order = main-node insertion order;
    # the main chain of a bucket appends new keys at the tail
    # (tests/oracle.py NestedOracle), so main position = arrival rank.
    _, first_idx, inv = np.unique(bk, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")  # groups by first arrival
    rank = np.empty(order.size, np.int64)
    rank[order] = np.arange(order.size)
    g = rank[inv]                                  # row -> group id
    g_first = first_idx[order]                     # group -> first row
    g_hv = hv_b[g_first]
    # main-chain order: new distinct keys APPEND to their bucket's main
    # chain (ht_nested.hh insert path; tests/oracle.py NestedOracle), so a
    # main node's position is its arrival rank within the bucket -- unlike
    # the chaining table's [first, rest LIFO] node order.
    b_g = (g_hv % np.asarray(num_buckets, g_hv.dtype)).astype(np.int64)
    gorder = np.argsort(b_g, kind="stable")
    bs = b_g[gorder]
    is_first = np.empty(bs.size, bool)
    is_first[:1] = True
    is_first[1:] = bs[1:] != bs[:-1]
    occ_sorted = np.arange(bs.size) - np.maximum.accumulate(
        np.where(is_first, np.arange(bs.size), -1))
    main_pos = np.empty(bs.size, np.int64)
    main_pos[gorder] = occ_sorted
    main_len = np.bincount(b_g, minlength=num_buckets)
    bucket_p = (hv_p % np.asarray(num_buckets, hv_p.dtype)).astype(np.int64)

    p_idx, g_idx = _hash_equal_candidates(g_hv, hv_p)
    keep = np.asarray(evaluate(p_idx, g_first[g_idx]), bool)

    INF = np.int64(1) << 62
    cand_pos = np.where(keep, main_pos[g_idx], INF)
    best = np.full(hv_p.size, INF, np.int64)
    np.minimum.at(best, p_idx, cand_pos)
    found = best < INF
    cmps = int(np.where(found, best + 1, main_len[bucket_p]).sum())
    matches = int(found.sum())

    emit = keep & (main_pos[g_idx] == best[p_idx])
    mp, mg = p_idx[emit], g_idx[emit]
    # expand each matched group: first row, then the subchain in LIFO
    # (descending row id = reverse insertion) order
    glen = np.bincount(g, minlength=g_first.size)
    cnt = glen[mg]
    out_p = np.repeat(mp, cnt).astype(np.int32)
    # group rows ascending, then reorder to [first, rest LIFO]
    grow_order = np.argsort(g, kind="stable")
    gstart = np.cumsum(glen) - glen
    csum = np.cumsum(cnt) - cnt
    within = np.arange(int(cnt.sum())) - np.repeat(csum, cnt)
    # position within the group's ascending row list: 0 -> first (which IS
    # the smallest row id), k>0 -> (len-k)-th = LIFO over the remainder
    asc = np.where(within == 0, 0, np.repeat(cnt, cnt) - within)
    out_b = grow_order[np.repeat(gstart[mg], cnt) + asc].astype(np.int32)
    return out_p, out_b, matches, cmps, int(out_p.size)
