"""The harness the port's randomized differential fuzzers share.

Each fuzzer (``fuzz_api``, ``fuzz_stream``, ``fuzz_order``, ``fuzz_dist``)
has two tiers of trials:

* ``small``: the JAX fuzzer's own draws, made in the same order from the
  same seeded numpy generator, so one seed names one case in both; checked
  against the insertion-simulating oracle (:mod:`.oracle`) or numpy;
* ``large``: the sizes that send every kernel through its multi-tile path
  (radix sorts past one block, scans past one tile, thousands of lookup
  windows), ragged lengths and bounded duplicates, checked against the
  port's native host engine (``hostengine.py``, the reference's
  semantics): counters exactly, pairs as multisets.

A tier is a :class:`Tier`: a generator ``gen(rng, trial, cut) -> case``
(every draw of one trial, made before it runs), a ``check(case, dev) ->
note`` that raises where the port disagrees, and for the large tier a
``reach(cases) -> dict`` that reads from the draws how far the kernels go.
:func:`run_tiers` draws a tier's cases from one generator (``seed`` for
the small tier, ``(seed, 1)`` for the large one), asserts the large tier's
reach before its first trial, and wraps any failure in a
:class:`TrialFailure` that names the trial's config and the command that
replays it.  ``cut`` caps the large tier's columns at ``2^cut`` rows (the
CPU tests' size); the reach is asserted only at full size.
:func:`spawn_ranks` starts the gloo ranks of ``fuzz_dist`` and
``zipf_capacity`` and runs one body on each.
"""

from __future__ import annotations

import argparse
import os
import queue
import tempfile
import time
from typing import Callable, NamedTuple

import numpy as np

from ..ops.bitonic import MAX_SEGMENT_BITONIC, RADIX_ONE_BLOCK_MAX
from ..ops.hashing import HASH_FUNCTORS_NP
from ..ops.layout import resolve_device
from ..ops.sort import probe_sort_chunk
from ..ops.strands_windowed import packed_key_bits
from ..utils.measure import card

#: elements of one tile of K3's single-pass scan (``csrc/scan.cu``:
#: kThreads / 32 warps x kQ x 32 lanes x 4)
SCAN_TILE = 4096
#: the large tier's least reach: K1 and K4 past one block's segment, K3
#: past one tile
REACH = dict(k1=RADIX_ONE_BLOCK_MAX, k4=RADIX_ONE_BLOCK_MAX, k3=SCAN_TILE)
#: lengths the large tier keeps its columns off (a multiple of one of these
#: would fill the last tile, window or segment exactly)
RAGGED_UNITS = (1024, 4096, 8192, 1 << 18)
FUNCTORS = ("murmur", "boncz", "fib", "mult", "identity")
#: the most chain comparisons the large tier asks of the host engine (a
#: few seconds of its walk)
HOST_WALK_LIMIT = 1 << 32
#: seconds :func:`spawn_ranks` waits for a rank's next message
RANK_TIMEOUT = 600


class TrialFailure(AssertionError):
    """A trial whose result differs from its ground truth (or raised)."""


class Tier(NamedTuple):
    trials: int                    #: default trial count
    gen: Callable                  #: (rng, trial, cut) -> case
    check: Callable                #: (case, dev) -> note
    reach: Callable | None = None  #: (cases) -> {"k1": seg, "k4": seg, ...}
    #: the kernels of :data:`REACH` this tier's path takes (asserted)
    kernels: tuple = ()


def walk_cost(bk, pk, num_buckets: int, hashfun: str) -> int:
    """Comparisons of every probe walking its whole bucket chain: the
    most the native host engine's walk makes on these columns."""
    f = HASH_FUNCTORS_NP[hashfun][1 if bk.dtype.itemsize == 8 else 0]
    nb = bk.dtype.type(num_buckets)
    blen = np.bincount((f(bk) % nb).astype(np.int64), minlength=num_buckets)
    return int(blen[(f(pk) % nb).astype(np.int64)].sum())


def truth(bk, pk, num_buckets: int, hashfun: str) -> str:
    """The large tier's ground truth for a case: "host", the native host
    engine, unless its walk would pass :data:`HOST_WALK_LIMIT`
    comparisons (``fib`` on u64 keys above 2^32 fills few buckets: its f64
    product keeps 53 bits), then "plain", the same call on the port's
    plain versions on the CPU, which count chains without walking them."""
    return ("host" if walk_cost(bk, pk, num_buckets, hashfun)
            <= HOST_WALK_LIMIT else "plain")


def require(cond, cfg: str, *what) -> None:
    """Raise :class:`TrialFailure` with the trial's config unless ``cond``."""
    if not cond:
        raise TrialFailure(f"{cfg}: " + " ".join(str(w) for w in what))


def pair_keys(prow, brow) -> np.ndarray:
    """(probe_row, build_row) pairs as one sorted int64 column, a multiset;
    build rows of -1 (left, semi, anti) sort as 2^32 - 1."""
    p = np.asarray(prow, np.int64)
    b = np.asarray(brow, np.int64) & 0xFFFFFFFF
    return np.sort((p << 32) | b)


def list_keys(pairs) -> np.ndarray:
    """:func:`pair_keys` of a list of (probe_row, build_row) tuples."""
    a = np.asarray(pairs, np.int64).reshape(-1, 2)
    return pair_keys(a[:, 0], a[:, 1])


def oracle_hash(hashfun: str, wide: bool):
    """The registry functor as the oracle takes it: int -> int."""
    f = HASH_FUNCTORS_NP[hashfun][1 if wide else 0]
    t = np.uint64 if wide else np.uint32
    return lambda k: int(f(t(k)))


def log_uniform(rng, lo_log2: int, hi_log2: int) -> int:
    """An integer log-uniform in [2^lo_log2, 2^hi_log2]."""
    return int(2 ** rng.uniform(lo_log2, hi_log2))


def bounds(lo_hi: tuple, cut: int | None) -> tuple:
    """A large-tier size range (log2 rows) under ``cut``: at most
    2^cut, and at least two doublings wide."""
    lo, hi = lo_hi
    return (lo, hi) if cut is None else (min(lo, cut - 2), min(hi, cut))


def ragged(n: int) -> int:
    """``n`` moved off every multiple of :data:`RAGGED_UNITS`."""
    while any(n % u == 0 for u in RAGGED_UNITS):
        n += 1
    return n


def probe_sort(P: int, domain: int | None, max_key: int) -> tuple:
    """``(kernel, segment)`` the windowed strands' probe sort takes for
    ``P`` keys up to ``max_key`` over a key ``domain``
    (``strands_windowed._sort_probes``): ("K1", seg), ("K4", seg), or
    (None, seg) for a library sort (seg None: a global one)."""
    if not domain:
        return None, None
    chunk = probe_sort_chunk(P, domain)
    if chunk is None:
        return None, None
    kb = packed_key_bits(chunk, domain)
    if kb is not None and max_key >> kb == 0:
        return "K1", chunk
    return ("K4" if chunk <= MAX_SEGMENT_BITONIC else None), chunk


def merge_reach(parts) -> dict:
    """The largest K1 / K4 segment and K3 length over ``parts``, each a
    dict like :data:`REACH` (0 where a kernel is not reached)."""
    parts = list(parts)
    return {k: max((p.get(k, 0) for p in parts), default=0) for k in REACH}


def replay(name: str, seed: int, tier: str, trial: int, dev, cut) -> str:
    cmd = (f"python3 -m hashjoin3d_tpu_torch.tools.{name} --seed {seed} "
           f"--tier {tier} --trials {trial + 1} --device {dev.type}")
    return cmd if cut is None else f"{cmd} (large columns cut to 2^{cut})"


def run_tiers(name: str, tiers: dict, dev, trials, seed: int, tier: str,
              log, cut: int | None = None) -> dict:
    """Run ``trials`` (None: each tier's default) of each tier ``tier``
    names ("small", "large" or "both") on ``dev``; returns per tier its
    trial count, seconds and (large) reach.  ``log`` takes one line a
    trial."""
    dev = resolve_device(dev)
    summary = {}
    for t in (("small", "large") if tier == "both" else (tier,)):
        spec = tiers[t]
        n = spec.trials if trials is None else trials
        rng = np.random.default_rng(seed if t == "small" else (seed, 1))
        cases = [spec.gen(rng, i, cut) for i in range(n)]
        reach = spec.reach(cases) if spec.reach is not None else None
        if reach is not None:
            log(f"{name} {t}: the draws reach " + ", ".join(
                f"{k} {v}" for k, v in reach.items()))
            short = {k: v for k, v in reach.items()
                     if k in spec.kernels and v <= REACH[k]}
            if cut is None and short:
                raise TrialFailure(
                    f"{name} {t} tier (seed {seed}, {n} trials): the draws "
                    f"do not take {sorted(short)} past "
                    f"{ {k: REACH[k] for k in short} } elements")
        t0 = time.perf_counter()
        for i, case in enumerate(cases):
            try:
                note = spec.check(case, dev)
            except Exception as e:  # named with its config and replay
                raise TrialFailure(
                    f"{name} {t} trial {i} failed on {dev}: {case.cfg} "
                    f"(seed {seed}; replay: "
                    f"{replay(name, seed, t, i, dev, cut)}): "
                    f"{type(e).__name__}: {e}") from e
            log(f"ok {t} {case.cfg}{note}  "
                f"[{time.perf_counter() - t0:6.1f}s]")
        summary[t] = dict(trials=n, seconds=time.perf_counter() - t0,
                          reach=reach)
        log(f"ALL {n} {t.upper()} TRIALS PASSED (seed {seed})")
    return summary


def rank_messages(procs, outq, timeout: float):
    """Yield what spawned ranks put on ``outq`` until every one of
    ``procs`` has exited; raise :class:`TrialFailure` when none says
    anything for ``timeout`` seconds while some still run."""
    quiet = 0.0
    while True:
        try:
            yield outq.get(timeout=1.0)
            quiet = 0.0
            continue
        except queue.Empty:
            pass
        if not any(p.is_alive() for p in procs):
            while True:  # what the last ones put before they exited
                try:
                    yield outq.get(timeout=0.5)
                except queue.Empty:
                    return
        quiet += 1.0
        if quiet > timeout:
            raise TrialFailure(f"no rank answered in {timeout:.0f} s")


def _rank(rank, world, store, device, body, args, outq):
    """One rank of :func:`spawn_ranks`: gloo over the file ``store``, then
    ``body(dev, put, *args)``; ``put(*msg)`` sends ``(rank, *msg)``, the
    body's end ``(rank, "done")``, an exception ``(rank, "error",
    traceback)``."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dev = torch.device(device)
    try:
        if dev.type == "cuda":  # every rank shares the one card
            torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=300))
        body(dev, lambda *msg: outq.put((rank, *msg)), *args)
        outq.put((rank, "done"))
    except Exception:
        outq.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(body, ranks: int, dev, *args, on_message) -> None:
    """Run ``body(dev, put, *args)`` (a module-level function) on
    ``ranks`` spawned processes joined in one gloo group, their tensors on
    ``dev``'s type; pass every ``(rank, kind, ...)`` the bodies put to
    ``on_message`` as it comes.  Raise :class:`TrialFailure` when a rank
    raised, fell quiet for :data:`RANK_TIMEOUT` seconds or exited before its
    body ended; every rank has exited on return."""
    import torch.multiprocessing as mp

    dev = resolve_device(dev)
    ctx = mp.get_context("spawn")
    outq = ctx.Queue()
    done, errors = set(), []
    with tempfile.TemporaryDirectory(prefix="hj3_gloo_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank,
                             args=(r, ranks, store, dev.type, body, args,
                                   outq))
                 for r in range(ranks)]
        for p in procs:
            p.start()
        try:
            for msg in rank_messages(procs, outq, RANK_TIMEOUT):
                if msg[1] == "done":
                    done.add(msg[0])
                elif msg[1] == "error":
                    errors.append(f"rank {msg[0]}:\n{msg[2]}")
                else:
                    on_message(msg)
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    if errors:
        raise TrialFailure(errors[0])
    if len(done) != ranks:
        raise TrialFailure(f"the ranks exited (codes "
                           f"{[p.exitcode for p in procs]}) before their "
                           "body ended")


def main(name: str, run, doc: str, argv=None, extra=None) -> int:
    """The fuzzers' command line: ``[--trials N] [--seed S] [--tier
    small|large|both] [--device cuda|cpu]``, plus ``extra(parser)``'s
    options, passed to ``run`` by keyword."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--trials", type=int, default=None,
                    help="trials a tier (default: the tier's own)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--tier", default="both",
                    choices=("small", "large", "both"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    if extra is not None:
        extra(ap)
    args = vars(ap.parse_args(argv))
    seed = args.pop("seed")
    if seed is None:
        seed = int(time.time()) % (1 << 31)
    dev = resolve_device(args.pop("device"))
    if dev.type == "cuda":
        print(card(), flush=True)
    print(f"{name}: master seed {seed} on {dev}", flush=True)
    run(dev, args.pop("trials"), seed, args.pop("tier"),
        lambda line: print(line, flush=True), **args)
    return 0
