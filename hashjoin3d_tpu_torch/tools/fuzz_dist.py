"""Randomized differential fuzz of the distributed join schedules.

Port of ``tools/fuzz_dist.py``.  Random mesh sizes x key widths x key
distributions x capacity policies x build hints on 4 gloo ranks (on
``cuda`` every rank's tensors sit on the one card, as in ``chip_smoke.py``
phase 11c).  Every trial runs the flat nested join plus
a randomly chosen second schedule (chaining / ring / hierarchical 2-D) on
the same data and checks, against plain-numpy ground truth:

- ``num_matches`` / ``num_unnested`` (the global counters),
- the global-id (probe_row, build_row) pair multiset across shards,
- ``overflow == 0`` under exact host-side capacity accounting, or, on the
  trials that deliberately undersize the probe capacity, ``overflow > 0``.

* small tier: the JAX fuzzer's draws (``tools/fuzz_dist.py:75-133``, same
  seed and the same cases as ``--devices`` equal to the ranks);
* large tier: 2^12 to 2^16 build and 2^12 to 2^17 probe rows a rank, a hot
  key on at most 64 build rows.

A mesh of ``nd`` ranks is the group's first ``nd`` ranks; the others hold
no shard and call no step.  The ranks gather every shard's result to rank
0, which checks the trial and tells every rank the verdict.

    python3 -m hashjoin3d_tpu_torch.tools.fuzz_dist [--trials N] [--seed S]
        [--tier small|large|both] [--device cuda|cpu]
"""

from __future__ import annotations

import time
import traceback
from types import SimpleNamespace

import numpy as np

from ..ops.hashing import hash_key_np
from ..ops.layout import resolve_device
from .fuzzing import (TrialFailure, bounds, log_uniform, main, pair_keys,
                      replay, require, spawn_ranks)

#: the large tier's sizes a rank (log2 rows: build, probe)
LARGE_BUILD = (12, 16)
LARGE_PROBE = (12, 17)
HOT_ROWS = 64
#: gloo ranks (the largest mesh)
RANKS = 4


def routing(keys, num_shards):
    """Host twin of ``shuffle.shard_of_key`` (double hash, width-matched)."""
    return (hash_key_np(hash_key_np(keys))
            % keys.dtype.type(num_shards)).astype(np.int64)


def exact_caps(keys, num_shards, n_loc):
    d = routing(keys, num_shards)
    src = np.arange(keys.size) // n_loc
    per_pair = np.bincount(src * num_shards + d,
                           minlength=num_shards * num_shards)
    per_shard_distinct = max(
        int(np.unique(keys[d == s]).size) for s in range(num_shards))
    return int(per_pair.max()), per_shard_distinct, d


def ground_truth(bk, pk):
    """(pair keys, matches, per-probe match counts) via numpy."""
    order = np.argsort(bk, kind="stable")
    sbk = bk[order]
    lo = np.searchsorted(sbk, pk, side="left")
    counts = np.searchsorted(sbk, pk, side="right") - lo
    prow = np.repeat(np.arange(pk.size), counts)
    within = np.arange(prow.size) - np.repeat(np.cumsum(counts) - counts,
                                              counts)
    brow = order[np.repeat(lo, counts) + within]
    return pair_keys(prow, brow), int(np.count_nonzero(counts)), counts


def config(c) -> str:
    return (f"trial {c.trial}: nd={c.nd} nb={c.bk.size} np={c.pk.size} "
            f"dom={c.dom} wide={c.wide} dist={c.dist} nbkt={c.nbkt} "
            f"hints={sorted(c.kw)} undersize={c.undersize}")


def finish(rng, case):
    """The capacities, hints and second schedule of ``tools/fuzz_dist.py:
    94-133``, draw for draw, after the columns."""
    bk, pk, nd = case.bk, case.pk, case.nd
    case.want, case.matches, counts = ground_truth(bk, pk)
    case.bcap, b_nk, _ = exact_caps(bk, nd, bk.size // nd)
    pcap, _, pdest = exact_caps(pk, nd, pk.size // nd)
    # per-shard output: keyed shards (flat) or probe-home shards (ring)
    out_by_key = max((int(counts[pdest == s].sum()) for s in range(nd)),
                     default=0)
    home = np.arange(pk.size) // (pk.size // nd)
    out_by_home = max((int(counts[home == s].sum()) for s in range(nd)),
                      default=0)
    case.ocap = max(out_by_key, out_by_home, 1)

    case.undersize = bool(rng.random() < 0.15) and pcap > 1
    if case.undersize:
        case.pcap = int(rng.integers(1, pcap))
    else:
        case.pcap = pcap + int(rng.integers(0, 5))

    case.nbkt = int(rng.integers(1, 2 * max(b_nk, 1) + 2))
    kw = {}
    if not case.wide and rng.random() < 0.5:
        kw["key_domain"] = case.dom
    if rng.random() < 0.5:
        kw["n_keys"] = b_nk + 1
    if case.wide and rng.random() < 0.3:
        kw["merged"] = bool(rng.random() < 0.5)
    case.kw = kw
    case.other = None
    if not case.undersize:  # drawn after the flat join's checks
        case.other = str(rng.choice(["chaining", "ring", "2d"] if nd >= 2
                                    else ["chaining", "ring"]))
    case.cfg = config(case)
    return case


def small_case(rng, trial, max_ranks, cut=None):
    """One trial's draws, in ``tools/fuzz_dist.py:82-133``'s order."""
    nd = int(rng.choice([d for d in (1, 2, 4, 8) if d <= max_ranks]))
    n_b = int(rng.integers(1, 400)) * nd
    n_p = int(rng.integers(1, 600)) * nd
    wide = bool(rng.random() < 0.3)
    dom = int(rng.integers(2, 3 * max(n_b, 4)))
    bk = rng.integers(0, dom, n_b, dtype=np.uint32)
    pk = rng.integers(0, dom, n_p, dtype=np.uint32)
    dist = str(rng.choice(["uniform", "hot", "dense"]))
    if dist == "hot":
        bk[: n_b // 2] = bk[0]
        pk[: n_p // 3] = bk[0]
    elif dist == "dense":
        bk = (np.arange(n_b) % max(dom // 2, 1)).astype(np.uint32)
    if wide:
        hi = np.uint64(int(rng.integers(1, 1 << 16))) << np.uint64(40)
        bk, pk = bk.astype(np.uint64) | hi, pk.astype(np.uint64) | hi
    return finish(rng, SimpleNamespace(trial=trial, nd=nd, bk=bk, pk=pk,
                                       wide=wide, dom=dom, dist=dist))


def large_case(rng, trial, max_ranks, cut=None):
    """Draws at the large tier's sizes a rank (``cut`` caps a rank's
    columns at 2^cut rows), duplicates bounded."""
    lo_b, hi_b = bounds(LARGE_BUILD, cut)
    lo_p, hi_p = bounds(LARGE_PROBE, cut)
    nd = int(rng.choice([d for d in (1, 2, 4, 8) if d <= max_ranks]))
    n_b = log_uniform(rng, lo_b, hi_b) * nd
    n_p = log_uniform(rng, lo_p, hi_p) * nd
    wide = bool(rng.random() < 0.3)
    dom = max(2, int(n_b * 2 ** rng.uniform(-2, 1)))
    bk = rng.integers(0, dom, n_b, dtype=np.uint32)
    pk = rng.integers(0, dom, n_p, dtype=np.uint32)
    dist = str(rng.choice(["uniform", "hot", "dense"]))
    if dist == "hot":
        bk[rng.choice(n_b, min(HOT_ROWS, n_b // 2), replace=False)] = bk[0]
        pk[rng.choice(n_p, n_p // 8, replace=False)] = bk[0]
    elif dist == "dense":
        bk = (np.arange(n_b) % max(dom // 2, 1)).astype(np.uint32)
    if wide:
        hi = np.uint64(int(rng.integers(1, 1 << 16))) << np.uint64(40)
        bk, pk = bk.astype(np.uint64) | hi, pk.astype(np.uint64) | hi
    return finish(rng, SimpleNamespace(trial=trial, nd=nd, bk=bk, pk=pk,
                                       wide=wide, dom=dom, dist=dist))


#: tier -> (default trials, generator)
TIERS = {"small": (30, small_case), "large": (4, large_case)}

# --- what a rank runs --------------------------------------------------------


def _step_out(out: dict) -> dict:
    """A step's result on the host: counters as ints, this shard's valid
    pairs as sorted keys."""
    v = out["out_valid"].cpu().numpy()
    res = {k: int(x) for k, x in out.items() if x.dim() == 0}
    res["pairs"] = pair_keys(out["probe_row"].cpu().numpy()[v],
                             out["build_row"].cpu().numpy()[v])
    return res


def schedules(case, meshes, dev) -> dict:
    """This rank's results of the trial's flat join and its second
    schedule (empty on a rank outside the mesh)."""
    import torch.distributed as dist

    from .. import parallel

    nd, kw = case.nd, case.kw
    flat, mesh2 = meshes(nd)
    if dist.get_rank() >= nd:
        return {}
    bkd = parallel.shard_axis(flat, case.bk)
    pkd = parallel.shard_axis(flat, case.pk)
    got = {"flat": _step_out(parallel.dist_nested_join(
        flat, num_buckets_per_shard=case.nbkt, build_capacity=case.bcap,
        probe_capacity=case.pcap, out_capacity=case.ocap, **kw)(bkd, pkd))}
    narrow = {k: v for k, v in kw.items() if k != "merged"}
    if case.other == "chaining":
        step = parallel.dist_chaining_join(
            flat, num_buckets_per_shard=case.nbkt, build_capacity=case.bcap,
            probe_capacity=case.pcap, out_capacity=case.ocap, **narrow)
        got["other"] = _step_out(step(bkd, pkd))
    elif case.other == "ring":
        step = parallel.dist_ring_nested_join(
            flat, num_buckets_per_shard=case.nbkt, build_capacity=case.bcap,
            out_capacity=case.ocap, **narrow)
        got["other"] = _step_out(step(bkd, pkd))
    elif case.other == "2d":
        axes = ("host", "chip")
        step = parallel.dist_nested_join_2d(
            mesh2, num_buckets_per_shard=case.nbkt,
            build_capacity=case.bk.size, probe_capacity=case.pk.size,
            out_capacity=case.want.size + 1, **narrow)
        got["other"] = _step_out(step(
            parallel.shard_axis(mesh2, case.bk, axes),
            parallel.shard_axis(mesh2, case.pk, axes)))
    return got


def verdict(case, shards: list) -> str:
    """Rank 0's check of a trial over every rank's results; returns a note
    or raises :class:`TrialFailure`."""
    cfg = case.cfg
    live = [s for s in shards if s]

    def merged(kind):
        counters = {k: v for k, v in live[0][kind].items() if k != "pairs"}
        for s in live[1:]:
            require({k: v for k, v in s[kind].items() if k != "pairs"}
                    == counters, cfg, kind, "counters differ between ranks")
        return counters, np.sort(np.concatenate([s[kind]["pairs"]
                                                 for s in live]))

    flat, pairs = merged("flat")
    if case.undersize:
        require(flat["overflow"] > 0, cfg, "overflow undetected")
        return "  [overflow detected]"
    require(flat["overflow"] == 0, cfg, "overflow", flat["overflow"])
    require(flat["num_matches"] == case.matches, cfg, "matches",
            flat["num_matches"], case.matches)
    require(flat["num_unnested"] == case.want.size, cfg, "unnested",
            flat["num_unnested"], case.want.size)
    require(np.array_equal(pairs, case.want), cfg, "flat pairs")
    other, pairs = merged("other")
    name = case.other
    require(other["overflow"] == 0, cfg, name, "overflow", other["overflow"])
    total = other.get("num_results", other.get("num_unnested"))
    require(total == case.want.size, cfg, name, "total", total,
            case.want.size)
    if "num_results" not in other:
        require(other["num_matches"] == case.matches, cfg, name, "matches")
    require(np.array_equal(pairs, case.want), cfg, name, "pairs")
    return f"  [+{name}]"


def mesh_cache(dev):
    """``meshes(nd) -> (flat mesh, 2-D mesh or None)`` over the group's
    first ``nd`` ranks, each made once; every rank calls it in the same
    order (making a mesh is collective)."""
    from .. import parallel

    cache = {}

    def meshes(nd):
        if nd not in cache:
            cache[nd] = (parallel.make_mesh(nd, device=dev),
                         parallel.make_mesh_2d(2, nd // 2, device=dev)
                         if nd >= 2 else None)
        return cache[nd]
    return meshes


def trials_on_group(dev, trials, seed, tier, cut, report) -> None:
    """Every trial of ``tier`` on this rank of the initialised process
    group, whose ranks all call this.  Rank 0 passes each trial's
    ``("line", tier, cfg, verdict)`` and each finished tier's ``("tier",
    tier, trials)`` to ``report``; every rank stops after a failed trial."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    meshes = mesh_cache(dev)
    for t in (("small", "large") if tier == "both" else (tier,)):
        default, gen = TIERS[t]
        n = default if trials is None else trials
        rng = np.random.default_rng(seed if t == "small" else (seed, 1))
        for i in range(n):
            case = gen(rng, i, world, cut)
            error = None
            try:
                mine = schedules(case, meshes, dev)
            except Exception:  # every rank still joins the gather
                mine, error = {}, traceback.format_exc()
            shards = [None] * world
            dist.all_gather_object(shards, (mine, error))
            answer = [None]
            if rank == 0:
                errors = [e for _, e in shards if e]
                try:
                    if errors:
                        raise TrialFailure(errors[0])
                    answer[0] = ("ok", verdict(case,
                                               [s for s, _ in shards]))
                except TrialFailure as e:
                    answer[0] = ("fail", str(e), t, i)
            dist.broadcast_object_list(answer, src=0)
            if rank == 0:
                report(("line", t, case.cfg, answer[0]))
            if answer[0][0] != "ok":
                return
        if rank == 0:
            report(("tier", t, n))


def _rank_trials(dev, put, trials, seed, tier, cut):
    """One rank of :func:`run` (a :func:`fuzzing.spawn_ranks` body)."""
    trials_on_group(dev, trials, seed, tier, cut, lambda msg: put(*msg))


def run(dev, trials, seed, tier, log, cut=None) -> dict:
    """``trials`` (None: 30 small, 4 large) of ``tier`` on :data:`RANKS`
    gloo ranks whose tensors sit on ``dev``; returns per tier its trial
    count and seconds (the first tier's include the ranks' start)."""
    dev = resolve_device(dev)
    summary = {}
    t0 = mark = time.perf_counter()

    def on_message(msg):
        nonlocal mark
        _, kind, t, *rest = msg
        if kind == "line":
            cfg, answer = rest
            if answer[0] != "ok":
                again = replay("fuzz_dist", seed, t, answer[3], dev, cut)
                raise TrialFailure(
                    f"fuzz_dist {t} trial {answer[3]} failed on {RANKS} "
                    f"gloo ranks ({dev}): {cfg}: {answer[1]} (seed {seed}; "
                    f"replay: {again})")
            log(f"ok {t} {cfg}{answer[1]}  "
                f"[{time.perf_counter() - t0:6.1f}s]")
        else:  # "tier": its trial count
            summary[t] = dict(trials=rest[0],
                              seconds=time.perf_counter() - mark)
            mark = time.perf_counter()
            log(f"ALL {rest[0]} {t.upper()} TRIALS PASSED (seed {seed})")

    spawn_ranks(_rank_trials, RANKS, dev, trials, seed, tier, cut,
                on_message=on_message)
    return summary


if __name__ == "__main__":
    raise SystemExit(main("fuzz_dist", run, __doc__))
