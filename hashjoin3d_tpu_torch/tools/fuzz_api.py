"""Randomized differential fuzz of ``join``'s routing tree.

Port of ``tools/fuzz_api.py``.  ``join`` picks a physical plan from the
data (dense-direct vs key_direct vs merged strand x nested/chaining x
unique x u32/u64 x hash functor x backend x mode); every trial drives one
random workload through it and checks the counters and the pair multiset
against a ground truth:

* small tier: the JAX fuzzer's draws (``tools/fuzz_api.py:28-48, 87-115``,
  same seed, same cases), checked against the insertion-simulating oracle
  (:mod:`.oracle`), which models ``ht_chaining.hh`` / ``ht_nested.hh``
  insertion per tuple;
* large tier: build rows log-uniform in [2^16, 2^20] and probe rows in
  [2^18, 2^24] (even trials a whole number of 2^18-key segments, so the
  probe sort segments and takes K1 or K4; odd trials mostly ragged), bounded
  duplicates, the device backend, checked against the native host engine
  (``join(..., backend="host")``), or where its chain walk would pass
  ``fuzzing.HOST_WALK_LIMIT`` comparisons against the same call on the
  plain versions on the CPU.

Route-selection faults live here: the JAX fuzzer caught the round-3
review's keydirect-chaining miss.

    python3 -m hashjoin3d_tpu_torch.tools.fuzz_api [--trials N] [--seed S]
        [--tier small|large|both] [--device cuda|cpu]

CUDA by default (it raises without a card); ``--device cpu`` runs the
plain versions.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from ..api import device_route, join
from .fuzzing import (FUNCTORS, Tier, bounds, list_keys, log_uniform, main,
                      merge_reach, oracle_hash, pair_keys, probe_sort,
                      ragged, require, run_tiers, truth)
from .oracle import ChainingOracle, NestedOracle

#: the large tier's sizes (log2 rows) and its bound on emitted pairs
LARGE_BUILD = (16, 20)
LARGE_PROBE = (18, 24)
LARGE_PAIRS = 1 << 25
#: rows of the large tier's hot key on the build side
HOT_ROWS = 256


def gen_keys(rng, n, dtype, dist):
    """``tools/fuzz_api.py:28-48``'s key column, draw for draw."""
    dom = int(rng.integers(4, max(8, 4 * n)))
    if dist == "perm":
        vals = rng.permutation(max(n, 1))[:n].astype(np.uint32)
    elif dist == "uniform":
        vals = rng.integers(0, dom, n, dtype=np.uint32)
    elif dist == "hot":
        vals = rng.integers(0, dom, n, dtype=np.uint32)
        vals[: n // 2] = vals[0]
    elif dist == "dense":
        vals = (np.arange(n) % max(dom // 4, 1)).astype(np.uint32)
    else:  # sparse: anywhere in the 30-bit space
        vals = rng.integers(0, 1 << 30, n, dtype=np.uint32)
    if dtype == np.uint64:
        hi = np.uint64(int(rng.integers(0, 1 << 20))) << np.uint64(32)
        wide = vals.astype(np.uint64) | hi
        if rng.random() < 0.3:  # some rows in a second hi-plane
            wide[rng.random(n) < 0.3] |= np.uint64(1) << np.uint64(52)
        return wide
    return vals


def config(case) -> str:
    return (f"trial {case.trial}: {case.how} u={case.unique} m={case.mode} "
            f"hf={case.hf} dt={np.dtype(case.dtype).name} nb={case.bk.size} "
            f"np={case.pk.size} bkt={case.nb_eff} be={case.backend} "
            f"hints={sorted(case.kw)} dist=({case.dist_b},{case.dist_p})")


def small_case(rng, trial, cut=None):
    """One trial's draws, in ``tools/fuzz_api.py:87-115``'s order."""
    dtype = np.uint64 if rng.random() < 0.25 else np.uint32
    n_b = int(rng.integers(1, 3000))
    n_p = int(rng.integers(1, 5000))
    dist_b = str(rng.choice(["perm", "uniform", "hot", "dense", "sparse"]))
    dist_p = str(rng.choice(["uniform", "hot", "dense", "sparse"]))
    bk = gen_keys(rng, n_b, dtype, dist_b)
    pk = gen_keys(rng, n_p, dtype, dist_p)
    if dtype == np.uint64 and rng.random() < 0.5:
        pk = (pk & np.uint64(0xFFFFFFFF)) | (bk[0] & ~np.uint64(0xFFFFFFFF))

    how = str(rng.choice(["nested", "chaining"]))
    unique = bool(rng.random() < 0.5) if how == "chaining" else False
    mode = str(rng.choice(["inner", "inner", "left", "semi", "anti"]))
    hf = str(rng.choice(list(FUNCTORS)))
    ndv = int(np.unique(bk).size)
    num_buckets = (None if rng.random() < 0.3
                   else int(rng.integers(1, 2 * ndv + 8)))
    kw = {}
    if rng.random() < 0.3:
        kw["n_keys"] = ndv
    if dtype == np.uint32 and rng.random() < 0.3:
        kw["key_domain"] = int(bk.max()) + 1 + int(rng.integers(0, 64))
    backend = "device"
    if hf == "murmur" and rng.random() < 0.6:  # host handles u64 too
        backend = str(rng.choice(["auto", "host"]))
    case = SimpleNamespace(
        trial=trial, dtype=dtype, bk=bk, pk=pk, dist_b=dist_b, dist_p=dist_p,
        how=how, unique=unique, mode=mode, hf=hf, num_buckets=num_buckets,
        kw=kw, backend=backend,
        nb_eff=(num_buckets if num_buckets is not None
                else max(1, kw.get("n_keys", ndv))))
    case.cfg = config(case)
    return case


def oracle_pairs(bk, pk, how, unique, num_buckets, hf_name):
    """(pairs, matches, cmps) of the oracle's walk."""
    hf = oracle_hash(hf_name, bk.dtype.itemsize == 8)
    if how == "chaining":
        return ChainingOracle(bk, num_buckets, hashfun=hf).probe(
            pk, unique=unique)
    orc = NestedOracle(bk, num_buckets, hashfun=hf)
    nested, matches, cmps = orc.probe(pk)
    return orc.unnest(nested), matches, cmps


def mode_view(pairs, n_probe, mode):
    """Expected (probe_row, build_row) multiset for each join mode."""
    matched = {p for p, _ in pairs}
    if mode == "inner":
        return sorted(pairs)
    if mode == "left":
        return sorted(pairs + [(p, -1) for p in range(n_probe)
                               if p not in matched])
    if mode == "semi":
        return sorted((p, -1) for p in matched)
    return sorted((p, -1) for p in range(n_probe) if p not in matched)


def call(case, dev, backend):
    return join(case.bk, case.pk, how=case.how, unique=case.unique,
                num_buckets=case.num_buckets, backend=backend,
                mode=case.mode, hashfun=case.hf, device=dev, **case.kw)


def check_small(case, dev) -> str:
    res = call(case, dev, case.backend)
    pairs, matches, cmps = oracle_pairs(case.bk, case.pk, case.how,
                                        case.unique, case.nb_eff, case.hf)
    want = mode_view(pairs, case.pk.size, case.mode)
    cfg = case.cfg
    require(res.num_matches == matches, cfg, "matches", res.num_matches,
            matches)
    require(res.num_cmps == cmps, cfg, "cmps", res.num_cmps, cmps)
    got = pair_keys(res.probe_rows, res.build_rows)
    require(np.array_equal(got, list_keys(want)), cfg, "pairs", got.size,
            len(want))
    require(res.num_results == len(want), cfg, "results", res.num_results,
            len(want))
    return ""


def large_keys(rng, n, dist, dom):
    """A u32 column of ``n`` keys over [0, dom) (``sparse``: the 30-bit
    space) whose duplicates stay bounded (``dom`` >= n / 4)."""
    if dist == "perm":
        return rng.permutation(n).astype(np.uint32)
    if dist == "dense":
        return (np.arange(n) % dom).astype(np.uint32)
    if dist == "sparse":
        return rng.integers(0, 1 << 30, n, dtype=np.uint32)
    vals = rng.integers(0, dom, n, dtype=np.uint32)
    if dist == "hot":
        vals[rng.choice(n, min(HOT_ROWS, n // 2), replace=False)] = vals[0]
    return vals


def large_case(rng, trial, cut=None):
    """Draws at the large tier's sizes (``cut`` caps every column at 2^cut
    rows).  Trials 0 and 2 (mod 4) are u32 inner or left joins over whole
    2^18-key segments whose probe sort segments: the first with every
    probe key inside the strand's domain (K1), the second with keys past
    2^key_bits (K4); odd trials draw freely, at ragged lengths or (one in
    four) whole 2^20-key blocks, where the probe sort policy's second cap
    gives 2^20-key segments from 2^23 probes over a domain past 2^20."""
    lo_b, hi_b = bounds(LARGE_BUILD, cut)
    lo_p, hi_p = bounds(LARGE_PROBE, cut)
    kind = ("K1", None, "K4", None)[trial % 4]
    dtype = (np.uint64 if kind is None and rng.random() < 0.25
             else np.uint32)
    n_b = ragged(log_uniform(rng, lo_b, hi_b - (kind is not None)))
    dist_b = str(rng.choice(["perm", "uniform", "hot", "dense"]
                            + ["sparse"] * (kind is None)))
    if dist_b == "perm" and rng.random() < 0.5:
        n_b = 1 << int(rng.integers(lo_b, hi_b))  # the dense-direct route
    dom = (n_b if dist_b == "perm"
           else max(1, int(n_b * 2 ** (rng.uniform(-1, 1) if kind
                                       else rng.uniform(-2, 2)))))
    bk = large_keys(rng, n_b, dist_b, dom)
    _, counts = np.unique(bk, return_counts=True)
    mean_dup = float((counts.astype(np.float64) ** 2).sum() / n_b)
    unit = 1 << min(18, hi_p - 2)
    if kind is not None:  # whole segments: the probe sort segments
        n_p = unit * int(2 ** rng.uniform(0, hi_p - unit.bit_length() + 1))
        n_p = max(unit, min(n_p, LARGE_PAIRS // unit * unit))
    elif rng.random() < 0.25:  # whole 2^20-key blocks: the second cap
        big = 1 << min(20, hi_p - 3)
        n_p = big * int(rng.integers(1, (1 << hi_p) // big + 1))
    else:
        n_p = ragged(log_uniform(rng, lo_p, hi_p))
    n_hit = min(int(n_p * rng.uniform(0.3, 1.0)), int(LARGE_PAIRS / mean_dup))
    # the other probes: in the build's domain, past it (to 2 dom: misses
    # wider than the strand's key bits) or sparse
    rest = ("sparse" if dist_b == "sparse" else "past" if kind == "K4"
            else "inside" if kind == "K1"
            else str(rng.choice(["inside", "past"])))
    top = {"sparse": 1 << 30, "inside": dom, "past": 2 * dom + 2}[rest]
    other = rng.integers(0, top, n_p - n_hit, dtype=np.uint32)
    if rest == "past" and other.size:
        other[0] = top - 1
    pk = np.concatenate([bk[rng.integers(0, n_b, n_hit)], other])
    pk = pk[rng.permutation(n_p)]
    dist_p = f"hits+{rest}"
    if dtype == np.uint64:
        hi = np.uint64(int(rng.integers(1, 1 << 20))) << np.uint64(32)
        bk, pk = bk.astype(np.uint64) | hi, pk.astype(np.uint64) | hi
    how = str(rng.choice(["nested", "chaining"]))
    unique = bool(rng.random() < 0.5) if how == "chaining" else False
    mode = str(rng.choice(["inner", "inner", "left"] + ["semi", "anti"]
                          * (kind is None)))
    hf = str(rng.choice(list(FUNCTORS)))
    ndv = int(counts.size)
    # at least ndv / 4 buckets: the host engine walks every chain
    num_buckets = (None if rng.random() < 0.3
                   else int(rng.integers(max(1, ndv // 4), 2 * ndv + 8)))
    kw = {}
    if rng.random() < 0.3:
        kw["n_keys"] = ndv
    if dtype == np.uint32 and dist_b != "sparse" and rng.random() < 0.3:
        kw["key_domain"] = int(bk.max()) + 1 + int(rng.integers(0, 64))
    case = SimpleNamespace(
        trial=trial, dtype=dtype, bk=bk, pk=pk, dist_b=dist_b, dist_p=dist_p,
        how=how, unique=unique, mode=mode, hf=hf, num_buckets=num_buckets,
        kw=kw, backend="device",
        nb_eff=(num_buckets if num_buckets is not None
                else max(1, kw.get("n_keys", ndv))))
    case.truth = truth(bk, pk, case.nb_eff, hf)
    case.cfg = config(case) + f" truth={case.truth}"
    return case


def check_large(case, dev) -> str:
    """The device join against the host engine's (or, past its walk limit,
    the plain versions' on the CPU): counters exactly, pairs as
    multisets."""
    res = call(case, dev, "device")
    want = (call(case, "cpu", "host") if case.truth == "host"
            else call(case, "cpu", "device"))
    cfg = case.cfg
    for k in ("num_matches", "num_cmps", "num_results"):
        require(getattr(res, k) == getattr(want, k), cfg, k,
                getattr(res, k), getattr(want, k))
    got = pair_keys(res.probe_rows, res.build_rows)
    require(np.array_equal(got, pair_keys(want.probe_rows, want.build_rows)),
            cfg, "pairs differ from the host engine's")
    return f" results={res.num_results} route={res.route_worst}"


def strand_domain(case) -> int | None:
    """The key domain the inner join's windowed strand sorts its probes
    over, by ``join``'s own routing (``api.device_route``): the build rows
    of a dense-direct table, a key_direct table's domain, None for the merged
    strands (their sort is the library's) and for semi and anti."""
    if case.mode in ("semi", "anti"):
        return None
    narrow, dense, dom = device_route(case.bk, case.pk, case.nb_eff,
                                      case.kw.get("key_domain"), case.hf)
    if case.how == "chaining" and dense:
        return case.bk.size
    return dom if narrow else None


def large_reach(cases) -> dict:
    """K1 / K4: the probe sort's segment (each strand call sorts its
    probes); K3: the build's run structure over the build rows."""
    parts = []
    for c in cases:
        kernel, seg = probe_sort(c.pk.size, strand_domain(c),
                                 int(c.pk.max()))
        parts.append({"k3": c.bk.size,
                      **({kernel.lower(): seg} if kernel else {})})
    return merge_reach(parts)


TIERS = {"small": Tier(60, small_case, check_small),
         "large": Tier(4, large_case, check_large, large_reach,
                       ("k1", "k4", "k3"))}


def run(dev, trials, seed, tier, log, cut=None) -> dict:
    """``trials`` (None: 60 small, 4 large) of ``tier`` on ``dev``."""
    return run_tiers("fuzz_api", TIERS, dev, trials, seed, tier, log, cut)


if __name__ == "__main__":
    raise SystemExit(main("fuzz_api", run, __doc__))
