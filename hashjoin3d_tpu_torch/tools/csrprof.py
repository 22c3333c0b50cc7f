"""Stage-level times of the Csr probe strand on one CUDA GPU.

Port of ``tools/csrprof.py`` (lines 29-124): each stage of
``ops/strands_windowed.py:direct_probe_strand_sorted`` at R20/S24 (2^24
probes of the reference's generator over a 2^20 dense-direct table) is
timed alone, on CUDA events, against the port's own functions: the probe
sort and its parts, ``safe_lookup`` (K2 with its coverage and one read),
K2 with coverage alone, the raw windowed lookups K2 and K2b at the strand's
window and at W = 1024, the decode of the packed words,
``_miss_chain_cmps``, the counter sums and the emission ``where``s.  Two
reference stages show what K2's coverage replaced: ``chunk_bases`` and the
unfused coverage check (per-key tensors over the stream, one read).  The
residual is the full strand minus the sum of its top-level stages (1, 2,
3, 3a, 3b, 4): what the stages alone do not explain (launch gaps, host
syncs).

    python3 -m hashjoin3d_tpu_torch.tools.csrprof [--logp 24] [--logt 20]

The card and its power limit print first.  Without a CUDA GPU it raises.
"""

from __future__ import annotations

import argparse
from typing import Callable, NamedTuple

import torch

from ..ops.bitonic import bitonic_sort_packed_segmented
from ..ops.chaining import build_chaining_host
from ..ops.layout import I64, from_numpy_u32, is_sorted_ascending, shr
from ..ops.sort import probe_sort_chunk, sort_segmented, window_for_chunk
from ..ops.strands_windowed import (_miss_chain_cmps, _pad_table,
                                    _sort_probes, direct_probe_strand_sorted,
                                    safe_lookup)
from ..ops.windowed import (chunk_bases, windowed_lookup,
                            windowed_lookup_covered)
from ..utils.gen import exp1_data
from ..utils.measure import card, events_ms, require_cuda


class Stage(NamedTuple):
    name: str
    fn: Callable
    top: bool = False                #: a top-level stage of the strand
    check: Callable | None = None    #: output -> bool


def stages(dev, logp: int = 24, logt: int = 20) -> list[Stage]:
    """The strand's stages on the reference's Csr data (seed 0) on
    ``dev``."""
    P, T = 1 << logp, 1 << logt
    rk_np, sa_np, _ = exp1_data(logt, logp, False, 0)
    pk = from_numpy_u32(sa_np, dev)
    tbl = build_chaining_host(from_numpy_u32(rk_np, dev), T,
                              dense_direct=True, n_keys=T)
    chunk = probe_sort_chunk(P, T)
    Wk = window_for_chunk(chunk, T)
    key_bits = max(int(T - 1).bit_length(), 1)
    skey, srow, _, _ = _sort_probes(pk, domain=T)
    direct = {W: _pad_table(tbl.direct, W) for W in (Wk, 1024)}
    d = safe_lookup(tbl.direct, skey, W=Wk)
    shift = tbl.direct_shift

    def decode(d):
        hit = d != 0
        return hit, d & ((1 << shift) - 1), shr(d, shift) if shift else d

    hit, brow, pos1 = decode(d)
    raw = {(W, db): (lambda W=W, db=db: windowed_lookup(
        direct[W], skey, W=W, db=db)) for W in (Wk, 1024) for db in (0, 1)}

    def same_as(key):
        return lambda out: torch.equal(out, raw[key]())

    def unfused_coverage():
        """The coverage check as safe_lookup made it before K2 reported
        it: per-key int64 tensors over the whole stream, one read."""
        k2 = skey.view(-1, 1024).to(I64)
        delta = k2 - chunk_bases(skey, direct[Wk].shape[0], 1024,
                                 Wk).to(I64)[:, None]
        in_range = (k2 >= 0) & (k2 < T)
        covered = ~in_range | ((delta >= 0) & (delta < Wk + 1024))
        return int((~covered.all(dim=1)).sum())

    return [
        Stage("FULL Csr strand (unique)",
              lambda: direct_probe_strand_sorted(tbl, pk, unique=True)),
        Stage(f"1 _sort_probes (checks + K1, segment {chunk})",
              lambda: _sort_probes(pk, domain=T), top=True),
        Stage("1a sort_segmented alone (K4 radix, 2-op)",
              lambda: sort_segmented(pk, chunk)),
        Stage("1b is_sorted_ascending check", lambda: is_sorted_ascending(pk)),
        Stage("1c K1 radix sort alone (keys + rows)",
              lambda: bitonic_sort_packed_segmented(pk, chunk, key_bits)),
        Stage(f"2 safe_lookup(direct) W={Wk} (K2 + coverage, 1 read)",
              lambda: safe_lookup(tbl.direct, skey, W=Wk), top=True),
        Stage(f"2a K2 + coverage W={Wk} (no read)",
              lambda: windowed_lookup_covered(direct[Wk], skey, T, W=Wk),
              check=lambda out: torch.equal(out[0], raw[Wk, 0]())),
        Stage(f"2b K2b raw W={Wk} db", raw[Wk, 1], check=same_as((Wk, 0))),
        Stage("2c K2 raw W=1024 (global-sort W)", raw[1024, 0]),
        Stage("2d K2b raw W=1024 db", raw[1024, 1], check=same_as((1024, 0))),
        Stage("2e reference: chunk_bases",
              lambda: chunk_bases(skey, direct[Wk].shape[0], 1024, Wk)),
        Stage("2f reference: unfused coverage check + read",
              unfused_coverage, check=lambda nbad: nbad == 0),
        Stage("3 decode packed word (3 elementwise)", lambda: decode(d),
              top=True),
        Stage("3a _miss_chain_cmps (0 misses)",
              lambda: _miss_chain_cmps(tbl.bucket_len, tbl.num_buckets, skey,
                                       ~hit, tbl.hashfun), top=True),
        Stage("3b counter sums (2x i64)",
              lambda: (hit.to(I64).sum(),
                       torch.where(hit, pos1, 0).to(I64).sum()), top=True),
        Stage("4 emission wheres (2x)",
              lambda: (torch.where(hit, srow, -1), torch.where(hit, brow, -1)),
              top=True),
    ]


def run(stage_list: list[Stage], n_elems: int, min_time: float,
        out=print) -> dict:
    """Check and time every stage; return name -> ms and the residual."""
    times = {}
    for s in stage_list:
        got = s.fn()
        if s.check is not None and not s.check(got):
            raise AssertionError(f"{s.name}: WRONG RESULTS")
        ms = events_ms(s.fn, min_time)
        times[s.name] = ms
        out(f"  {s.name:48s} {ms:9.4f} ms  {ms * 1e6 / n_elems:7.4f} ns/elem")
    full = times[stage_list[0].name]
    parts = sum(times[s.name] for s in stage_list if s.top)
    times["residual"] = full - parts
    out(f"  {'residual: FULL - (1 + 2 + 3 + 3a + 3b + 4)':48s} "
        f"{times['residual']:9.4f} ms  (stages sum to {parts:.4f} ms)")
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logp", type=int, default=24)
    ap.add_argument("--logt", type=int, default=20)
    ap.add_argument("--min-time", type=float, default=0.4)
    args = ap.parse_args(argv)
    dev = require_cuda()
    print(f"card: {card()}; P = 2^{args.logp} probes, T = 2^{args.logt} keys",
          flush=True)
    run(stages(dev, args.logp, args.logt), 1 << args.logp, args.min_time)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
