"""Randomized fuzz of the out-of-core streaming probes.

Port of ``tools/fuzz_stream.py``.  Random table layouts (dense-direct /
key_direct / merged u32 / merged u64) x hash functors x chunk sizes
(ragged tails guaranteed) x tables (chaining with and without ``unique``,
nested) through ``ops.streaming.stream_probe_chaining`` /
``stream_probe_nested``: counters bit-equal and pair multisets identical to
the ground truth.

* small tier: the JAX fuzzer's draws (``tools/fuzz_stream.py:29-98``,
  same seed, same cases), checked against the insertion-simulating oracle
  (:mod:`.oracle`);
* large tier: build rows log-uniform in [2^16, 2^20], chunks of 2^18 to
  2^22 keys (even trials whole multiples of the 2^18-key segment, whose
  probe sort segments: K1 or K4; odd trials not, which sort with the
  library), one to four whole chunks and a ragged tail, checked against
  the native host engine (``host_chaining_join`` / ``host_nested_join``),
  or where its chain walk would pass ``fuzzing.HOST_WALK_LIMIT``
  comparisons against the same stream on the plain versions on the CPU.
  The layouts take turns (dense-direct, merged u32, key_direct, merged
  u64); the dense-direct trials probe up to twice the table's rows, so
  their keys pass the strand's key bits (K4), the key_direct ones stay
  inside their domain (K1).

The JAX fuzzer was motivated by a real escape: the dense-direct
ragged-tail pad correction hashed the pad key with the murmur default
instead of the table's functor.

    python3 -m hashjoin3d_tpu_torch.tools.fuzz_stream [--trials N]
        [--seed S] [--tier small|large|both] [--device cuda|cpu]
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from ..hostengine import host_chaining_join, host_nested_join
from ..ops.chaining import build_chaining_host
from ..ops.layout import key_column
from ..ops.nested import build_nested_host
from ..ops.streaming import stream_probe_chaining, stream_probe_nested
from .fuzzing import (FUNCTORS, Tier, bounds, list_keys, log_uniform, main,
                      merge_reach, oracle_hash, pair_keys, probe_sort,
                      ragged, require, run_tiers, truth)
from .oracle import ChainingOracle, NestedOracle

LAYOUTS = ("dense", "keydirect", "merged32", "merged64")
#: the large tier's layouts in turn: the even trials' whole segments go to
#: the two layouts whose probe sort segments
LARGE_LAYOUTS = ("dense", "merged32", "keydirect", "merged64")
#: the large tier's key_direct domain stays within the first segment cap's
#: reach (2^20 keys, ``ops/sort.py:probe_sort_chunk``)
KEYDIRECT_DOMAIN = 7 << 17
#: the large tier's sizes (log2 rows: build rows, chunk keys)
LARGE_BUILD = (16, 20)
LARGE_CHUNK = (18, 22)
#: whole chunks of a large trial's probe column (before its ragged tail)
LARGE_CHUNKS = 4


def config(c) -> str:
    return (f"trial {c.trial}: {c.how}/{c.layout} hf={c.hf} u={c.unique} "
            f"nb={c.bk.size} np={c.pk.size} bkt={c.nbkt} chunk={c.chunk}")


def finish(case):
    """The build hints of the case's layout (``tools/fuzz_stream.py:
    68-77``) and its config string."""
    kw = dict(hashfun=case.hf)
    if case.layout == "dense":
        case.nbkt = min(case.nbkt, max(case.bk.size, 1))
        kw.update(dense_direct=True, n_keys=case.bk.size)
        if case.how == "chaining" and not case.unique:
            kw.update(full_chain_index=True)
    elif case.layout == "keydirect":
        kw.update(key_domain=int(case.pk.max()) + 1,
                  n_keys=int(np.unique(case.bk).size))
    case.kw = kw
    case.cfg = config(case)
    return case


def small_case(rng, trial, cut=None):
    """One trial's draws, in ``tools/fuzz_stream.py:38-66``'s order."""
    layout = str(rng.choice(list(LAYOUTS)))
    hf = str(rng.choice(list(FUNCTORS)))
    how = str(rng.choice(["chaining", "nested"]))
    unique = bool(rng.random() < 0.5)
    n_p = int(rng.integers(1, 8192))
    chunk = int(rng.integers(32, 4096))

    if layout == "dense":
        n_b = int(rng.integers(1, 4096))
        bk = rng.permutation(max(n_b, 1))[:n_b].astype(np.uint32)
        pk = rng.integers(0, n_b + 32, n_p, dtype=np.uint32)
    else:
        n_b = int(rng.integers(1, 3000))
        dom = int(rng.integers(2, 3 * max(n_b, 4)))
        bk = rng.integers(0, dom, n_b, dtype=np.uint32)
        pk = rng.integers(0, dom + 8, n_p, dtype=np.uint32)
        if layout == "merged32":
            bk = bk * np.uint32(65521) + np.uint32(3)  # sparse domain
            pk = pk * np.uint32(65521) + np.uint32(3)
        elif layout == "merged64":
            hi = np.uint64(int(rng.integers(1, 1 << 16))) << np.uint64(40)
            bk = bk.astype(np.uint64) | hi
            pk = pk.astype(np.uint64) | hi
    ndv = int(np.unique(bk).size)
    nbkt = int(rng.integers(1, 2 * ndv + 2))
    return finish(SimpleNamespace(trial=trial, layout=layout, hf=hf, how=how,
                                  unique=unique, chunk=chunk, bk=bk, pk=pk,
                                  nbkt=nbkt))


def chunk_bound(case) -> int:
    """Pair slots one chunk's expansion needs: ``tools/fuzz_stream.py``'s
    16 a probe (plus 16), or the most equal-key pairs a chunk holds where
    that is more (a non-unique chaining or nested probe of a few keys with
    hundreds of rows each: the JAX fuzzer's seed 20261017 trial 37 emits
    862,878 pairs from 5,496 probes, and its fixed bound refuses it)."""
    sk = np.sort(case.bk)
    counts = (np.searchsorted(sk, case.pk, side="right")
              - np.searchsorted(sk, case.pk, side="left"))
    per_chunk = np.bincount(np.arange(case.pk.size) // case.chunk,
                            weights=counts)
    most = int(per_chunk.max()) if per_chunk.size else 0
    return max(16 * case.chunk + 16, most)


def stream(case, dev, out):
    """The port's stream on ``dev``, ``out`` pair slots a chunk: (matches,
    cmps, unnested or None, sorted pair keys)."""
    keys = key_column(case.bk, dev)
    if case.how == "chaining":
        tbl = build_chaining_host(keys, case.nbkt, **case.kw)
        m, c, got = stream_probe_chaining(
            tbl, case.pk, chunk_size=case.chunk, unique=case.unique,
            collect_pairs=True, out_per_chunk=out)
        u = None
    else:
        tbl = build_nested_host(keys, case.nbkt, **case.kw)
        m, c, u, got = stream_probe_nested(
            tbl, case.pk, chunk_size=case.chunk, collect_pairs=True,
            out_per_chunk=out)
    prow = np.concatenate([p for p, _ in got] or [np.zeros(0, np.int64)])
    brow = np.concatenate([b for _, b in got] or [np.zeros(0, np.int32)])
    return m, c, u, pair_keys(prow, brow)


def compare(case, got, want) -> None:
    m, c, u, keys = got
    wm, wc, wu, wkeys = want
    require(m == wm, case.cfg, "matches", m, wm)
    require(c == wc, case.cfg, "cmps", c, wc)
    require(u == wu, case.cfg, "unnested", u, wu)
    require(np.array_equal(keys, wkeys), case.cfg, "pairs", keys.size,
            wkeys.size)


def check_small(case, dev) -> str:
    hf = oracle_hash(case.hf, case.bk.dtype.itemsize == 8)
    if case.how == "chaining":
        pairs, m, c = ChainingOracle(case.bk, case.nbkt, hashfun=hf).probe(
            case.pk, unique=case.unique)
        u = None
    else:
        orc = NestedOracle(case.bk, case.nbkt, hashfun=hf)
        nested, m, c = orc.probe(case.pk)
        pairs = orc.unnest(nested)
        u = len(pairs)
    compare(case, stream(case, dev, chunk_bound(case)),
            (m, c, u, list_keys(pairs)))
    return ""


def large_case(rng, trial, cut=None):
    """Draws at the large tier's sizes (``cut`` caps the build and the
    chunks at 2^cut rows)."""
    lo_b, hi_b = bounds(LARGE_BUILD, cut)
    lo_c, hi_c = bounds(LARGE_CHUNK, cut)
    layout = LARGE_LAYOUTS[trial % 4]
    hf = str(rng.choice(list(FUNCTORS)))
    how = str(rng.choice(["chaining", "nested"]))
    unique = bool(rng.random() < 0.5)
    seg = 1 << lo_c
    if trial % 2 == 0:  # whole segments: the probe sort segments
        chunk = seg * int(rng.integers(1, 1 << (hi_c - lo_c)))
    else:
        chunk = ragged(log_uniform(rng, lo_c, hi_c))
    n_p = chunk * int(rng.integers(1, LARGE_CHUNKS + 1)) + ragged(
        int(rng.integers(1, chunk)))
    n_b = ragged(log_uniform(rng, lo_b, hi_b))
    if layout == "dense":
        bk = rng.permutation(n_b).astype(np.uint32)
        pk = rng.integers(0, 2 * n_b, n_p, dtype=np.uint32)
        pk[0] = 2 * n_b - 1  # past the strand's key bits
    else:
        dom = max(2, int(n_b * 2 ** rng.uniform(-2, 1)))
        if layout == "keydirect":
            dom = min(dom, KEYDIRECT_DOMAIN)
        bk = rng.integers(0, dom, n_b, dtype=np.uint32)
        pk = rng.integers(0, dom + dom // 8 + 8, n_p, dtype=np.uint32)
        if layout == "merged32":
            bk = bk * np.uint32(65521) + np.uint32(3)
            pk = pk * np.uint32(65521) + np.uint32(3)
        elif layout == "merged64":
            hi = np.uint64(int(rng.integers(1, 1 << 16))) << np.uint64(40)
            bk = bk.astype(np.uint64) | hi
            pk = pk.astype(np.uint64) | hi
    ndv = int(np.unique(bk).size)
    # at least ndv / 4 buckets: the host engine walks every chain
    nbkt = int(rng.integers(max(1, ndv // 4), 2 * ndv + 2))
    case = finish(SimpleNamespace(trial=trial, layout=layout, hf=hf, how=how,
                                  unique=unique, chunk=chunk, bk=bk, pk=pk,
                                  nbkt=nbkt))
    case.truth = truth(bk, pk, case.nbkt, hf)
    case.cfg += f" truth={case.truth}"
    return case


def check_large(case, dev) -> str:
    """The stream against the host engine's join of the whole column (or,
    past its walk limit, the same stream on the plain versions on the
    CPU)."""
    out = chunk_bound(case)
    if case.truth == "plain":
        want = stream(case, "cpu", out)
        compare(case, stream(case, dev, out), want)
        return f" pairs={want[3].size}"
    if case.how == "chaining":
        op, ob, m, c = host_chaining_join(case.bk, case.pk, case.nbkt,
                                          unique=case.unique,
                                          hashfun=case.hf)
        want = (m, c, None, pair_keys(op, ob))
    else:
        op, ob, m, c, u = host_nested_join(case.bk, case.pk, case.nbkt,
                                           hashfun=case.hf)
        want = (m, c, u, pair_keys(op, ob))
    compare(case, stream(case, dev, out), want)
    return f" pairs={want[3].size}"


def large_reach(cases) -> dict:
    """K1 / K4: the probe sort of a whole chunk (dense-direct: over the
    table's rows; key_direct: over its domain); K3: the build's run
    structure over the build rows."""
    parts = []
    for c in cases:
        domain = {"dense": c.bk.size,
                  "keydirect": c.kw.get("key_domain")}.get(c.layout)
        full = c.pk[:c.pk.size - c.pk.size % c.chunk]
        kernel, seg = probe_sort(c.chunk, domain,
                                 int(full.max()) if full.size else 0)
        parts.append({"k3": c.bk.size,
                      **({kernel.lower(): seg} if kernel else {})})
    return merge_reach(parts)


TIERS = {"small": Tier(40, small_case, check_small),
         "large": Tier(4, large_case, check_large, large_reach,
                       ("k1", "k4", "k3"))}


def run(dev, trials, seed, tier, log, cut=None) -> dict:
    """``trials`` (None: 40 small, 4 large) of ``tier`` on ``dev``."""
    return run_tiers("fuzz_stream", TIERS, dev, trials, seed, tier, log, cut)


if __name__ == "__main__":
    raise SystemExit(main("fuzz_stream", run, __doc__))
